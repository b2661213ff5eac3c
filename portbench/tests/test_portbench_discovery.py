"""A configuration, a traffic mix and a metric added as files only are
found by name; a metric's reader returning nothing leaves it out."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import spec, traffic  # noqa: E402


def test_every_named_piece_exists():
    bench = spec.load_benchmark(ROOT)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.load_config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec.load_traffic(w["traffic"])
        assert any(c["name"] == w["config"] for c in bench["configs"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_new_files_are_found_without_edits(tmp_path):
    bench_dir = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, bench_dir / sub)
    cfg = spec.load_config("internlm2-20b")
    cfg["name"] = "newmodel"
    (bench_dir / "configs" / "newmodel.json").write_text(json.dumps(cfg))
    mix = spec.load_traffic("offload-chat")
    mix["reply"] = dict(mix["reply"], mean=50)
    (bench_dir / "traffic" / "short-chat.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "tokens_seen.py").write_text(
        "def read(rec):\n    return len(rec['requests'])\n")
    (bench_dir / "metrics" / "never.py").write_text(
        "def read(rec):\n    return None\n")
    bench = {"workloads": [{"name": "newmodel.short-chat",
                            "config": "newmodel", "traffic": "short-chat",
                            "chips": 1}],
             "end_to_end": [{"name": "tokens_seen", "unit": "n",
                             "better": "higher", "bound": 0.01,
                             "source": "host_clock"}],
             "per_layer": [{"name": "never", "unit": "%", "better": "higher",
                            "source": "program_counter", "layer": "x",
                            "moves": "tokens_seen"}]}
    cell = spec.find_cell(bench, "newmodel.short-chat")
    assert spec.load_config(cell["config"], bench_dir)["name"] == "newmodel"
    m = spec.load_traffic(cell["traffic"], bench_dir)
    t = traffic.Traffic(m, seed=1, vocab=100, cache_len=2048)
    assert t.session(0).replies[0] >= 1
    rec = {"requests": [(0.0, [1.0])] * 3}
    e2e = spec.metrics_for(bench, cell["name"], trace=False)
    assert spec.read_metrics(e2e, rec, bench_dir) == {
        "tokens_seen": {"value": 3.0, "unit": "n"}}
    per = spec.metrics_for(bench, cell["name"], trace=True)
    assert [m["name"] for m in per] == ["never"]
    assert spec.read_metrics(per, rec, bench_dir) == {}


def test_metrics_for_respects_workloads_keys():
    bench = spec.load_benchmark(ROOT)
    names = [m["name"] for m in spec.metrics_for(
        bench, "internlm2-20b.long-prompt", trace=True)]
    assert "prefix_hit_token_pct" not in names
    assert "device_idle_pct" in names
    e2e = [m["name"] for m in spec.metrics_for(
        bench, "internlm2-20b.long-prompt", trace=False)]
    assert "setup_s" in e2e and "output_tokens_per_s" in e2e
    assert "tpot_p95_ms" not in e2e
