"""No module that benchmark/run.py loads has the top-level name jax,
jaxlib, flax or deepflame_tpu, compared whole (deepflame_torch begins
with deepflame_t, as deepflame_tpu does): checked in a fresh process
that drives a whole run on the CPU at n = 8."""
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

PROBE = r"""
import sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import run  # the entry script's own set-up
from harness import main, spec
for m in list(spec.BENCH.joinpath("metrics").glob("*.py")):
    spec.metric_reader(m.stem)
cell = spec.load_cell("tgv192-dnn-bf16.kernel")
cell.config["n"] = 8
main.run(cell, 9, 0.5, False, time.perf_counter(), device="cpu")
print(json.dumps({"forbidden": main.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run(
        [sys.executable, "-c", "import json\n" + PROBE, str(BENCH),
         str(BENCH.parent)], capture_output=True, text=True, timeout=600,
        cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "deepflame_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "deepflame_tpu"} & set(got["tops"])


def test_the_guard_compares_whole_names(monkeypatch):
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    from harness import main
    monkeypatch.setitem(sys.modules, "deepflame_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert "deepflame_tpu" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepflame_tpu.ops", sys)
    assert "deepflame_tpu" in main.forbidden_modules()
