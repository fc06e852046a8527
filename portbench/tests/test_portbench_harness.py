"""The harness is driven by data: a configuration, a generator of inputs, a
traffic mix, a cell and a per-layer metric added as new files and entries in
BENCHMARK.json, with no file of portbench edited, run as a GPU run drives
them (past the look for a card, on the CPU)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import run

REPO = os.path.dirname(run.HERE)


def test_cell_config_traffic_and_metric_added_as_files(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = run.load_json(REPO, "BENCHMARK.json")
    cfg = run.load_json(run.HERE, "configs", "zika.json")
    cfg.update(refs=8, genome_len=2000, counter_size=100003)
    (tmp_path / "portbench/configs/mini.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/gen/short_panel.py").write_text(textwrap.dedent("""
        from portbench.gen.panel_reads import write_panel_reads

        def write(out_dir, cfg, traffic, seed):
            return write_panel_reads(out_dir, traffic["reads"], traffic["read_len"],
                                     cfg["refs"], cfg["genome_len"], 0.05, 0.01, 0.0, seed)
    """))
    (tmp_path / "portbench/traffic/few_reads.json").write_text(json.dumps(
        {"command": "stream", "inputs": "short_panel", "reads": 500, "read_len": 90,
         "flags": {"ks": [12], "sketch_size": 200, "min_kmer_occ": 2}}))
    (tmp_path / "portbench/metrics/jobs_run.py").write_text(
        "def read(rec):\n    return len(rec['jobs'])\n")
    bench["configs"].append({"name": "mini", "source": "a test", "reduced": ["refs"],
                             "file": "portbench/configs/mini.json", "why": "a test"})
    bench["workloads"].append({"name": "mini.few", "config": "mini", "traffic": "few_reads",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "drivers",
                               "moves": "reads_per_s", "workloads": ["mini.few"]})
    for m in bench["end_to_end"]:
        if m["name"] == "reads_per_s":
            m["workloads"].append("mini.few")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent("""
        import json, os
        from portbench import run
        assert run.HERE == os.path.abspath("portbench"), run.HERE
        bench = run.load_json(run.ROOT, "BENCHMARK.json")
        cell, e2e, per_layer = run.cell_spec(bench, "mini.few")
        cfg = run.load_json(run.HERE, "configs", cell["config"] + ".json")
        tr = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
        out = run.run_cell(cfg, tr, 99, 0.0, False, e2e + per_layer, "cpu", 0.0)
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, RKMH_TPU_PANEL_CACHE="0")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out
    assert set(out["metrics"]) == {"reads_per_s", "setup_s", "jobs_run"}
    assert out["metrics"]["jobs_run"]["value"] == 1
    assert os.listdir(tmp_path / "portbench/.cache/inputs") == ["short_panel"]
    assert list(out)[-1] == "checks"


def test_cell_spec_lists_only_the_cells_metrics():
    bench = run.load_json(REPO, "BENCHMARK.json")
    for cell in bench["workloads"]:
        c, e2e, per_layer = run.cell_spec(bench, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per_layer and all(m["moves"] in names for m in per_layer)
        for m in e2e + per_layer:
            assert os.path.exists(os.path.join(run.HERE, "metrics", m["name"] + ".py"))
        assert os.path.exists(os.path.join(run.HERE, "traffic", c["traffic"] + ".json"))


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run prints no result and exits non-zero."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "zika.stream",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
