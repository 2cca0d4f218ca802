"""Share of the traced slice with no operation on the device."""

from perfbench.lib.readers import idle_pct as read  # noqa: F401
