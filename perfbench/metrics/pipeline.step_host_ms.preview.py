"""Mean host time per denoise step of a preview batch, less its blocking waits (program spans)."""

from perfbench.lib.spans import step_host_ms as read  # noqa: F401
