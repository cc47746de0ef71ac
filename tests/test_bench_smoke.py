"""bench.py harness smoke: protect its contract (ONE parseable JSON line
with metric/value/unit/vs_baseline/extra) and its peak table from
regressions.
"""

import importlib.util
import json
import os


def _load_bench():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("bench_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_tiny_prints_contract_line(capsys, monkeypatch):
    monkeypatch.setenv("GEOMRL_BENCH_TINY", "1")
    bench = _load_bench()
    bench.TINY = True  # module constant is read at import; force it
    bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "rigid_insertion_hepi_collection_env_steps_per_sec"
    assert rec["value"] > 0 and rec["unit"] == "env-steps/sec"
    assert "vs_baseline" in rec
    extra = rec["extra"]
    assert extra["cloth_hanging_collection_env_steps_per_sec"] > 0
    assert extra["rigid_insertion_train_iteration"]["iteration_s"] > 0


def test_bench_peak_lookup_h100():
    bench = _load_bench()
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12


def test_bench_peak_lookup_unknown_device_raises():
    import pytest

    bench = _load_bench()
    for kind in ("cpu", "NVIDIA H100", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="no peak"):
            bench.peak_flops(kind)
