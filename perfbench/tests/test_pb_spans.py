"""The per-layer metrics that read the program's spans: each is declared in
``BENCHMARK.json`` as a program span in ms, moving its cell's end-to-end
metric, and its reader (``perfbench/metrics/<name>.py``) exists."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPAN_METRICS = ["pipeline.step_host_ms.preview", "pipeline.step_host_ms.edit",
                "pipeline.step_blocked_ms.preview", "pipeline.step_blocked_ms.edit",
                "serve.codec_ms.preview", "serve.codec_ms.edit", "serve.prep_ms.edit"]


def test_span_metrics_are_declared_with_their_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        assert m["moves"] == ("edit_s" if name.endswith(".edit") else "preview_p95_s")
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").is_file()
