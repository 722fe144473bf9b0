"""The port's configuration: the match fields of ``cook_tpu/config.py``'s
``MatcherConfig`` (:17-97), with the same names, defaults and
validation, so that a config file means the same in both packages.  The
``tpu-*`` backend names keep the JAX package's spelling; in the port they
name the same kernels on the card."""

from __future__ import annotations

import logging
from dataclasses import dataclass

BACKENDS = ("auto", "tpu-greedy", "tpu-auction", "tpu-waterfill",
            "tpu-megakernel", "cpu")


@dataclass
class MatcherConfig:
    """Per-pool matcher knobs (reference: default-fenzo-scheduler-config
    config.clj:110-117).

    ``backend``: "auto" = greedy up to ``auto_large_j_threshold`` jobs,
    then waterfill or auction per ``auto_packing``; "tpu-greedy" =
    bit-exact greedy (kernel K5 on the card); "tpu-auction" = top-K
    adaptive auction + waterfill tail; "tpu-waterfill" = prefix packing
    with no J x H work; "tpu-megakernel" = the fused cycle, whose split
    path matches with the greedy; "cpu" = the numpy greedy golden."""

    backend: str = "auto"
    auto_large_j_threshold: int = 2000
    # above the threshold: "throughput" -> waterfill (lowest latency,
    # looser packing), "tight" -> adaptive auction + waterfill tail
    auto_packing: str = "throughput"
    # cmask rows below this density are "constrained" jobs: the auto
    # backend's waterfill path routes them to the exact greedy
    sparse_cmask_density: float = 0.5
    max_jobs_considered: int = 1000
    # auction: num_refresh is an upper bound; the refresh loop exits once
    # a pass admits fewer than auction_min_refresh_gain new jobs
    auction_num_prefs: int = 16
    auction_num_rounds: int = 8
    auction_num_refresh: int = 64
    auction_min_refresh_gain: int = 16
    waterfill_num_rounds: int = 32
    # tightness-improving migration rounds after waterfill converges
    # (upper bound; exits when no move lands)
    waterfill_num_compaction: int = 16

    def __post_init__(self):
        # validate and migrate at config time, not per match cycle
        if self.backend == "tpu-auction-pallas":
            logging.getLogger(__name__).warning(
                "DEPRECATED matcher backend tpu-auction-pallas was removed; "
                "rewriting to tpu-auction — update the config")
            self.backend = "tpu-auction"
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown matcher backend {self.backend!r}")
        if self.auto_packing not in ("throughput", "tight"):
            raise ValueError(f"unknown auto_packing "
                             f"{self.auto_packing!r} (throughput|tight)")
