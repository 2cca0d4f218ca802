"""Mean PNG decode and encode time per edit request in the HTTP handler (program spans)."""

from perfbench.lib.spans import codec_ms as read  # noqa: F401
