"""Mean PNG encode time per preview request in the HTTP handler (program spans)."""

from perfbench.lib.spans import codec_ms as read  # noqa: F401
