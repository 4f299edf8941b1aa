"""Pallas kernels (Triton route) for the hot paths; see ops/route.py."""
from .pallas_path import (render_path_pallas, render_path_pallas_interpret,
                          TILE)
from .pallas_mis import render_mis_pallas, render_mis_pallas_interpret
from .pallas_mis_bwd import render_mis_decoupled, render_mis_fused
from .decoupled import render_path_decoupled, shade_replay, trace_records
from .pallas_shade import render_path_decoupled_fused
