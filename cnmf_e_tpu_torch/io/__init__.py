"""Data layer (port of ``cnmf_e_tpu/io``): movie readers (TIFF/HDF5/AVI/
NPY), the frame-blocked chunk store and result export. Host-side numpy
only; the streaming fit uploads the store's blocks to the device.
"""

from cnmf_e_tpu_torch.io.movie import load_movie, probe_movie
from cnmf_e_tpu_torch.io.store import MovieStore, distribute_movie

__all__ = ["load_movie", "probe_movie", "MovieStore", "distribute_movie"]
