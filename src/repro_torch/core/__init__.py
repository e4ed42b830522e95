"""DQF — the paper's contribution (dual index + dynamic search) in PyTorch."""

from .types import (DQFConfig, QuantConfig, SearchResult,  # noqa: F401
                    SearchStats, TierConfig)
from .dqf import DQF  # noqa: F401
from .ssg import SSGParams, build_ssg  # noqa: F401
from . import beam_search  # noqa: F401
from .dynamic_search import dynamic_search  # noqa: F401
from .decision_tree import train_tree, predict, FEATURE_NAMES  # noqa: F401
from .workload import ZipfWorkload  # noqa: F401
from .recall import ground_truth, recall_at_k  # noqa: F401
