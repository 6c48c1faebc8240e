"""BENCHMARK.json against the contract's charset and shape, and every file
it names found by name."""

import re

from portbench.lib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = common.benchmark()


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_shape():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= cells
        # each cell a metric lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2  # setup_s and one more
        assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])
        assert w["chips"] == 1


def test_files_found_by_name():
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert common.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = common.workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert (common.HERE / "loops" / f"{cell['loop']}.py").is_file()
        common.traffic_params(w["traffic"])
        assert all(v is not None for v in cell["limits"].values())
    for m in BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]).read)


def test_metrics_for_cells():
    for w in BENCH["workloads"]:
        e2e = common.metrics_for(w["name"], BENCH, trace=False)
        layer = common.metrics_for(w["name"], BENCH, trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer.values():
            assert m["moves"] in e2e
