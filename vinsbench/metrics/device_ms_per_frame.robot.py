"""device_ms_per_frame.robot: the reader of device_ms_per_frame.fleet, over a robot's
profiled frames."""

from vinsbench import harness

read = harness.reader("device_ms_per_frame.fleet")
