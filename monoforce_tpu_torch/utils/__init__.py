"""Host utilities of the port: YAML and calibration IO, timing and
profiling, numeric helpers, the dataset split and the batch loaders, and
file-locked CSV writing (the JAX package's ``monoforce_tpu.utils``, own
copies; timing and profiling on the card)."""

from monoforce_tpu_torch.utils.io import read_yaml, write_to_yaml, load_calib
from monoforce_tpu_torch.utils.timing import timing, Timer
from monoforce_tpu_torch.utils.misc import normalize, position
from monoforce_tpu_torch.utils.data import (compile_data, NumpyLoader,
                                            PrefetchLoader)
from monoforce_tpu_torch.utils.locking import (PathLock, write_to_csv,
                                               append_to_csv)
from monoforce_tpu_torch.utils.profiling import trace, measure

__all__ = [
    "read_yaml", "write_to_yaml", "load_calib",
    "timing", "Timer",
    "normalize", "position",
    "compile_data", "NumpyLoader", "PrefetchLoader",
    "PathLock", "write_to_csv", "append_to_csv",
    "trace", "measure",
]
