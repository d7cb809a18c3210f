"""kernels_per_frame.robot: the reader of kernels_per_frame.fleet, over a robot's
profiled frames."""

from vinsbench import harness

read = harness.reader("kernels_per_frame.fleet")
