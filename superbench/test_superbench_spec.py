"""Every piece of every cell is found by name, and the files hold what the
program runs: each configuration file matches the program's config and
its frozen Pareto table the program's Pareto set."""
import re

import pytest

from repro_torch.serving.executor import serving_config
from repro_torch.core.pareto import pareto_subnets
from superbench import run, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = spec.cell(w["name"])
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert spec.traffic(cell["trace"]["kind"]).arrivals
    assert cell["slo_ms"] > 0 and cell["rate_qps"] > 0
    assert set(cell["limits"]) and all(v >= 0 for v in
                                       cell["limits"].values())
    assert cell["why"] == w["why"] and len(w["why"]) <= 200
    names = {m["name"] for m in spec.metrics_of(w["name"], True, BENCH)}
    assert ("roofline.sliced_matmul" in names) == (
        cell["slice_mode"] == "switch")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_programs_config(c):
    arch = spec.config(c["name"], BENCH)
    prog = arch["program"]
    cfg = serving_config(prog["arch"], "cpu", "full", prog.get("units"))
    run.check_arch(arch, cfg)
    pts = pareto_subnets(cfg)
    run.check_points(pts, arch["pareto"])
    assert set(c["reduced"]) <= set(arch["published"])
    assert arch["source"] == c["source"]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert callable(spec.reader(m["name"]).read)
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])


def test_names_and_bounds():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.workload("no-such-cell", BENCH)
