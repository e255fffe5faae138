"""pw.parallel — scale-out across processes.

Counterpart of ``pathway_tpu/parallel/``. The port carries the TCP
process mesh (``process_mesh.py``, a copy) that multi-process pipelines
open, and the engine's two device-exchange hooks (``device_exchange.py``,
``column_plane.py``), which keep every shuffle on the host wire. The
device mesh and its collectives wait for the multi-device slice (ROADMAP
item A9).
"""
