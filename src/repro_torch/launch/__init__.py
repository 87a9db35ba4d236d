"""Command-line entry points of the port, and the dry run's machinery
(``mesh.py``, ``dryrun.py``, ``dryrun_lib.py``, ``op_analysis.py``).

The reference's ``launch/device_shim.py`` has no counterpart: it only
forces simulated XLA host devices into ``XLA_FLAGS`` before ``import
jax``, and the port's multi-device forms take lists of torch devices
(``launch/mesh.py``) instead. Its ``hlo_analysis.py`` becomes
``op_analysis.py``: there is no HLO to parse, so the port's real program
is traced op by op."""
