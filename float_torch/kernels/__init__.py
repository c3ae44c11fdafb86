"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``).

Nothing here builds or imports CUDA code at import time: each wrapper
builds its library at its first launch (``build.load``).  ``LAUNCHES``
counts kernel launches by kernel name; a wrapper adds one exactly where
it launches, so a run can show that its main path went through the
kernels.
"""
from collections import Counter

LAUNCHES: Counter = Counter()
