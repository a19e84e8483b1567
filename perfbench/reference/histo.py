"""Plain NumPy reference of HISTO: an equi-width histogram of a dataset's
keys, and its control, which holds the counts in int16, the precision
below the configuration's int32.  Imports nothing of the program."""
from __future__ import annotations

import numpy as np


def bins_of(keys: np.ndarray, num_bins: int, key_domain: int) -> np.ndarray:
    width = max(key_domain // num_bins, 1)
    return np.minimum(keys.astype(np.int64) // width, num_bins - 1)


def histogram(keys: np.ndarray, num_bins: int, key_domain: int) -> np.ndarray:
    """int64 [num_bins]: how many of ``keys`` fall in each bin."""
    return np.bincount(bins_of(keys, num_bins, key_domain), minlength=num_bins)


def control_histogram(keys: np.ndarray, num_bins: int, key_domain: int) -> np.ndarray:
    """The histogram counted in int16 (wrapping), as PE buffers one
    precision narrower than the configuration's would hold it."""
    return histogram(keys, num_bins, key_domain).astype(np.int16).astype(np.int64)


def bins_wrong(got: np.ndarray, want: np.ndarray) -> int:
    """How many bins of ``got`` differ from ``want``."""
    return int(np.count_nonzero(np.asarray(got, np.int64) != want))


def cells_touched(keys: np.ndarray, num_bins: int, key_domain: int,
                  chunk_size: int) -> int:
    """Distinct bins of each chunk of a dataset, summed over its chunks."""
    b = bins_of(keys, num_bins, key_domain)
    return sum(len(np.unique(b[i:i + chunk_size])) for i in range(0, len(b), chunk_size))
