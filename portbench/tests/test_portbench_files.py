"""Every file the benchmark finds by name loads and names only what exists."""
import json

import pytest

from portbench import common

BENCH = common.BENCH


def bench_json():
    with open(common.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cells():
    return sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", cells())
def test_workload_names_known_files(name):
    cell = common.load_json("workloads", name)
    cfg = common.load_json("configs", cell["config"])
    tr = common.load_json("traffic", cell["traffic"])
    assert (BENCH / "entries" / f"{cell['entry']}.py").is_file()
    assert (common.ROOT / cfg["source_file"]).is_file()
    assert len(tr["gt_counts"]) == tr["batch"] and tr["distinct_batches"] >= 3
    for m in cell["per_layer"]:
        reader = common.load_module("metrics", m.partition(".")[0])
        assert callable(reader.read) and reader.UNIT
    kinds = {m["kind"] for m in cell["end_to_end"]}
    assert kinds <= {"rate", "interval_p95", "setup"} and "setup" in kinds
    # a limit of 0 is an exact comparison
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())


def test_benchmark_json_matches_the_files():
    b = bench_json()
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        cfg = json.loads((common.ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = common.load_json("workloads", w["name"])
        assert w["config"] in configs and cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        assert {m["name"] for m in cell["end_to_end"]} == {
            n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        want = {m["name"] for m in b["per_layer"] if w["name"] in m["workloads"]}
        assert set(cell["per_layer"]) == want
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in common.load_json("workloads", w)["end_to_end"]}


@pytest.mark.parametrize("name", ["rpn_head", "assign", "nms", "roi_align", "roi_align_bwd"])
def test_kernel_work_files(name):
    mod = common.load_module("kernels", name)
    assert mod.NAMES and mod.DTYPE in ("bfloat16", "float32")
