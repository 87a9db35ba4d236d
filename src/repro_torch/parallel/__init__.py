"""Multi-device deployment of the port: the LM's stage planning and its
executable stage pipeline (``pipeline.py``), the sharding rules of the
production meshes (``sharding.py``, ``act.py``), the BCNN's
stage-pipelined forward (``bcnn_pipeline.py``) and its data-parallel bulk
forward (``bcnn_data_parallel.py``), the forms over a plain list of torch
devices or a ``launch/mesh.py`` mesh."""
