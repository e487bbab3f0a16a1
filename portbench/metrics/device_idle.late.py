"""The device's idle share of the profiled segment in the trained scene's
cell: the reading of ``device_idle.train.py``."""

from portbench.harness import reader

read = reader("device_idle.train").read
