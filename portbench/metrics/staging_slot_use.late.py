"""The staging's useful share of its slots in the trained scene's cell: the
reading of ``staging_slot_use.train.py`` (100 × ``staging.pairs_emitted``
over ``staging.slots``; with sub-frame groups both count the backward's
stagings too)."""

from portbench.harness import reader

read = reader("staging_slot_use.train").read
