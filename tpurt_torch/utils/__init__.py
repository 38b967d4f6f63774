from tpurt_torch.utils.stats import (
    STATS,
    ProfilePhase,
    ProgressReporter,
    StatsRegistry,
    print_stats,
)
