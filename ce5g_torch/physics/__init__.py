from .profiles import (
    MAX_PATHS,
    PROFILE_INDEX,
    PROFILE_NAMES,
    ProfileTable,
    build_profile_table,
    used_subcarrier_bins,
)
from .jakes import jakes_gains_at_times, path_gains_symbol_sampled
from .pilots import (
    PilotPattern,
    block_pattern,
    comb_pattern,
    extract_pilots,
    insert_pilots,
    make_pattern,
    scattered_pattern,
)
from .mimo import apply_channel, apply_channel_common_grid, frequency_response
from .simulate import (
    Frame,
    FrameDraws,
    FrameParams,
    draw_frames,
    simulate_batch,
    simulate_frame,
    table_for,
)

__all__ = [
    "MAX_PATHS",
    "PROFILE_INDEX",
    "PROFILE_NAMES",
    "ProfileTable",
    "build_profile_table",
    "used_subcarrier_bins",
    "jakes_gains_at_times",
    "path_gains_symbol_sampled",
    "PilotPattern",
    "block_pattern",
    "comb_pattern",
    "extract_pilots",
    "insert_pilots",
    "make_pattern",
    "scattered_pattern",
    "apply_channel",
    "apply_channel_common_grid",
    "frequency_response",
    "Frame",
    "FrameDraws",
    "FrameParams",
    "draw_frames",
    "simulate_batch",
    "simulate_frame",
    "table_for",
]
