"""The benchmark of the PyTorch/CUDA port ``vins_rgbd_fast_torch``.

    python -m vinsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``.  Everything is found by name:
``configs/<config>.json`` (a deployment), ``traffic/<traffic>.json`` (a
mix: its driver and parameters), ``drivers/<driver>.py`` (a way of driving
the port), ``metrics/<metric>.py`` (a per-layer reader).  ``traffic/``
and ``bounds.py`` are frozen copies of the program's generator and kernel
arithmetic; ``reference/`` is the plain reference that decides ``correct``.
"""
