"""A configuration, a traffic mix and a metric are found by their names
in BENCHMARK.json, as new files, with no file of the harness edited."""
import json
import shutil

from benchmark import core


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(core.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = core.load_manifest()
    cfg = json.loads((core.ROOT / manifest["configs"][0]["file"]).read_text())
    cfg["name"] = "mobilenet_v2_bf16_copy"
    (bench / "configs" / "mobilenet_v2_bf16_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "nvdec_live_b16.json").read_text())
    mix["rate_frames_per_s"] = 1234
    (bench / "traffic" / "live_slow.json").write_text(json.dumps(mix))
    (bench / "metrics" / "frames_seen.total.py").write_text(
        "def read(rec):\n    return float(len(rec.label_times))\n")
    manifest["configs"].append({"name": "mobilenet_v2_bf16_copy", "source": "x",
                                "file": "benchmark/configs/mobilenet_v2_bf16_copy.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "mobilenet_v2_bf16_copy.live_slow",
                                  "config": "mobilenet_v2_bf16_copy",
                                  "traffic": "live_slow", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "frames_seen.total", "unit": "frames",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "decoder", "moves": "latency_p50_ms",
                                  "workloads": ["mobilenet_v2_bf16_copy.live_slow"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "latency_p50_ms":
            m["workloads"].append("mobilenet_v2_bf16_copy.live_slow")
    cell = core.find_cell(manifest, "mobilenet_v2_bf16_copy.live_slow", bench)
    assert cell.config["name"] == "mobilenet_v2_bf16_copy"
    assert cell.traffic["rate_frames_per_s"] == 1234
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.total"]
    assert "latency_p50_ms" in {m["name"] for m in cell.end_to_end}
    rec = core.Record("x", 2, 1.0, label_times=[0.1, 0.2, 0.3])
    assert core.load_reader("frames_seen.total", bench)(rec) == 3.0
    # the copy left every file that was there unchanged
    for f in core.BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and "tests" not in f.parts:
            assert (bench / f.relative_to(core.BENCH)).read_bytes() == f.read_bytes()
