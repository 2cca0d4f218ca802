"""Mean engine preparation time per edit batch: tokenizing and the source resize (program spans)."""

from perfbench.lib.spans import prep_ms as read  # noqa: F401
