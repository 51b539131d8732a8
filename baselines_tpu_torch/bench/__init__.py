"""Results and plotting tools (counterpart of baselines_tpu/bench/__init__.py, with the
same exports): the benchmark suites, the monitor CSV writer and loader; pandas and
matplotlib are imported only inside the functions that need them."""

from baselines_tpu_torch.bench.benchmarks import (
    get_benchmark,
    list_benchmarks,
    register_benchmark,
)
from baselines_tpu_torch.bench.monitor_io import ResultsWriter, load_results

__all__ = [
    "get_benchmark",
    "list_benchmarks",
    "register_benchmark",
    "ResultsWriter",
    "load_results",
]
