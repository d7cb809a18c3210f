"""vins_rgbd_fast_torch — the PyTorch/CUDA port of ``vins_rgbd_fast_tpu``.

The JAX package beside this one is the reference; every module here keeps
the path, function names and NamedTuple field names of its JAX
counterpart, so a reader finds each twin by its path.  Idiom differences:

  * plain functions on tensors with an explicit leading batch dimension B
    where the JAX package relies on ``vmap``;
  * Python loops where JAX uses ``scan``/``while_loop``;
  * an explicit ``device`` on every constructor, no implicit CPU fallback;
  * the three TPU kernels (FAST+NMS, one LK pyramid level, the LK
    iteration loop) are hand-written CUDA kernels for Hopper (``csrc/``),
    each with a plain PyTorch version beside its wrapper that runs for CPU
    tensors;
  * the host runtime's C++ (``runtime/csrc/``: the rosbag reader, the
    stream runtime, PNG unfiltering) is built with ``g++`` at first use,
    and a failed build raises.
"""

__version__ = "0.1.0"
