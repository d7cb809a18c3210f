"""device_idle_pct.robot: the reader of device_idle_pct.fleet, over a robot's
profiled frames."""

from vinsbench import harness

read = harness.reader("device_idle_pct.fleet")
