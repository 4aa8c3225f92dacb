"""Flamelet-generated manifolds: the FlaRe table and its DeePFGM network."""
from .deep import DeepFGM, train_deep_fgm
from .table import (FlameletTable, lookup, lookup_many, make_synthetic_table,
                    read_flare_table, write_flare_table)

__all__ = ["DeepFGM", "train_deep_fgm", "FlameletTable", "lookup", "lookup_many",
           "make_synthetic_table", "read_flare_table", "write_flare_table"]
