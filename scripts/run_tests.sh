#!/bin/bash
# Crash-isolated test runner.
#
# Plain `pytest tests/` dies wholesale if any test segfaults — observed
# rarely in XLA CPU compilation under memory pressure. pytest-xdist runs tests in
# worker processes: a segfault is reported as that one test FAILED
# ("worker crashed") and the rest of the suite still runs.
#
#   scripts/run_tests.sh               # whole suite, 1 isolated worker
#   GEOMRL_TEST_WORKERS=2 scripts/run_tests.sh tests/test_train.py
set -u
cd "$(dirname "$0")/.."
exec python -m pytest tests/ -q -p xdist -n "${GEOMRL_TEST_WORKERS:-1}" "$@"
