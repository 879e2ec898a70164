"""The merge kernels and the torch ops around them (port of paimon_tpu/ops):
lane compression (lanes.py), the sort/segment/select preamble (merge.py)
and the two hand-written Hopper kernels (hopper_kernels.py)."""
