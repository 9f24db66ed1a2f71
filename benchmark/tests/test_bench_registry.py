"""The harness finds a configuration, a traffic mix and a metric by the
names in `BENCHMARK.json`, and a cell added with data files alone runs."""

import json
import shutil

import pytest

from benchmark.harness import registry
from benchmark.harness.cell import run_cell
from benchmark.tests.small import LIGHTGLUE, SEED


def test_every_cell_resolves():
    bench = registry.load_json(registry.ROOT / "BENCHMARK.json")
    assert [w["name"] for w in bench["workloads"]] == [
        "dkm-match", "lightglue-zeb", "lightglue-match", "dkm-zeb"]
    for w in bench["workloads"]:
        c = registry.cell(w["name"], bench)
        assert c.config["head"] == w["config"]
        registry.kind(c.traffic["kind"])
        registry.head(c.config["head"])
        registry.reference(w["config"])
        for m in c.per_layer:
            mod = registry.metric(m["name"])
            assert callable(mod.read)
        names = {m["name"] for m in c.end_to_end}
        assert {"pairs_per_s", "setup_s", "peak_mem_gib"} <= names
        assert c.per_layer


def test_config_files_name_their_sources():
    bench = registry.load_json(registry.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = registry.load_json(registry.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_cell_added_from_files_alone(tmp_path):
    """A new traffic file and a `BENCHMARK.json` entry, and nothing else:
    gim_lightglue at batch 2 of pairs."""
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(registry.BENCH_DIR / d, tmp_path / d)
    pairs = registry.load_json(tmp_path / "traffic" / "pairs.json")
    (tmp_path / "traffic" / "pairs-b2.json").write_text(
        json.dumps({**pairs, "batch": 2}))
    bench = registry.load_json(registry.ROOT / "BENCHMARK.json")
    bench["workloads"].append({
        "name": "lightglue-pairs-b2", "config": "gim_lightglue",
        "traffic": "pairs-b2", "chips": 1, "why": "a test cell"})
    for m in bench["per_layer"]:
        if "workloads" in m and "lightglue-match" in m["workloads"]:
            m["workloads"].append("lightglue-pairs-b2")
    cell = registry.cell("lightglue-pairs-b2", bench, tmp_path)
    assert cell.traffic["batch"] == 2
    assert "lightglue.glue_ms" in {m["name"] for m in cell.per_layer}
    r = run_cell("lightglue-pairs-b2", SEED, 0.5, True, device="cpu",
                 overrides=LIGHTGLUE, bench=bench, bench_dir=tmp_path)
    assert r.correct, r.checked
    assert r.attempted % 2 == 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
