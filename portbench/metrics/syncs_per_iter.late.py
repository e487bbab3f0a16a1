"""Host syncs an iteration in the trained scene's cell: the reading of
``syncs_per_iter.train.py`` (one drain chunk under the CUDA sync debug
mode)."""

from portbench.harness import reader

read = reader("syncs_per_iter.train").read
