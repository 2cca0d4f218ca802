"""Mean time per denoise step of an edit that the host blocks in ``host.sync`` calls (program spans).

Launches that wait for room in a full launch queue are not ``host.sync``
calls: that wait is in ``pipeline.step_host_ms.edit``."""

from perfbench.lib.spans import step_blocked_ms as read  # noqa: F401
