"""Mean host time per denoise step of an edit, less its blocking copies (program spans).

It includes the time that kernel launches wait for room in a full launch
queue: at the DiT's 4500 launches a step that wait is the card's, not the
host's (``pipeline.step_blocked_ms.edit`` counts only the ``host.sync``
calls)."""

from perfbench.lib.spans import step_host_ms as read  # noqa: F401
