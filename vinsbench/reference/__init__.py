"""The plain reference that decides ``correct``: plain PyTorch and numpy,
importing nothing of the program (``vins_rgbd_fast_torch``) and taking
nothing it made.  It reads the benchmark's own frames and truth, and the
program's answers only to judge them."""
