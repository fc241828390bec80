"""Data and tensor parallelism over `torch.distributed` (port of
`ecgmm_tpu/parallel/`): the mesh (`mesh.py`), the collectives with their
backwards and the data-parallel context (`collectives.py`), the
tensor-parallel placement (`tp.py`) and a launcher of local ranks
(`launch.py`)."""
