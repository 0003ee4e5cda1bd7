"""The harness finds a cell's files by the names in BENCHMARK.json: a
configuration, a traffic mix or a metric dropped into its folder is
found without editing any code."""

import json

import pytest

from perfbench import bundle, spec


def test_files_dropped_into_their_folders_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-model.json").write_text(
        json.dumps({"name": "new-model", "hidden_size": 8}))
    (tmp_path / "traffic" / "new-mix.json").write_text(
        json.dumps({"kind": "serve", "mode": "backlog"}))
    (tmp_path / "metrics" / "new_metric.cell.py").write_text(
        "def read(b):\n    return 2.0 * b.seconds\n")
    (tmp_path / "limits" / "new-model.new-mix.json").write_text(
        json.dumps({"x": {"limit": 1}}))
    bench = {
        "configs": [{"name": "new-model", "source": "s",
                     "file": str(tmp_path / "configs" / "new-model.json"),
                     "reduced": []}],
        "workloads": [{"name": "new-model.new-mix", "config": "new-model",
                       "traffic": "new-mix", "chips": 1, "why": "w"}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "other_s", "unit": "s",
                        "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "new_metric.cell", "unit": "s",
                       "moves": "setup_s",
                       "workloads": ["new-model.new-mix"]}]}
    cell = spec.cell("new-model.new-mix", root="/", bench=bench,
                     base=str(tmp_path))
    assert cell.config["hidden_size"] == 8
    assert cell.traffic["mode"] == "backlog"
    assert cell.limits == {"x": {"limit": 1}}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    b = bundle.Bundle(cell="c", sizes={}, config={}, traffic={},
                      seconds=3.0, setup_s=1.0, t0=0.0, t1=3.0,
                      perf_to_wall=0.0)
    assert spec.reader("new_metric.cell", base=str(tmp_path))(b) == 6.0


def test_every_metric_of_the_committed_benchmark_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2


@pytest.mark.parametrize("limits", [None, {}, {"sample": {"requests": 8}},
                                    {"x": 0.1}])
def test_a_cell_whose_limits_name_no_number_is_refused(tmp_path, limits):
    """A cell compares its output with the reference: with no limits file,
    or one that bounds no number, it would report correct on nothing."""
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "m.json").write_text("{}")
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({"kind": "train"}))
    if limits is not None:
        (tmp_path / "limits" / "m.t.json").write_text(json.dumps(limits))
    bench = {"configs": [{"name": "m", "file": str(tmp_path / "configs"
                                                   / "m.json")}],
             "workloads": [{"name": "m.t", "config": "m", "traffic": "t",
                            "chips": 1}],
             "end_to_end": [], "per_layer": []}
    with pytest.raises(ValueError, match="limit"):
        spec.cell("m.t", root="/", bench=bench, base=str(tmp_path))


def test_a_pending_cell_is_found_by_name_and_stays_out_of_the_benchmark():
    bench = spec.benchmark()
    committed = {w["name"] for w in bench["workloads"]}
    cell = spec.cell("qwen2-1.5b.chat-backlog")
    assert cell.name not in committed
    assert {m["name"] for m in cell.end_to_end} == {"serve_tok_s",
                                                    "setup_s"}
    assert cell.per_layer and all(m["moves"] == "serve_tok_s"
                                  for m in cell.per_layer)
    assert spec.with_pending(bench, "no-such-cell") is bench
