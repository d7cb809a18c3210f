"""fast_nms_roofline.robot: the reader of fast_nms_roofline.fleet, over a robot's
profiled frames."""

from vinsbench import harness

read = harness.reader("fast_nms_roofline.fleet")
