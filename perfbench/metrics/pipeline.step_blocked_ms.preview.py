"""Mean time per denoise step of a preview batch that the host waits on the card (program spans)."""

from perfbench.lib.spans import step_blocked_ms as read  # noqa: F401
