"""pw.parallel — scale-out across processes.

Counterpart of ``pathway_tpu/parallel/``. The port carries the TCP
process mesh (``process_mesh.py``) that multi-process pipelines open,
the elastic plane over it (``membership.py``: join/leave intents and the
fence-time rebalance; ``supervisor.py``: whole-mesh restarts from the
agreed checkpoint; ``bluegreen.py``: whole-plan swaps behind the swap
gate), and the engine's two device-exchange hooks (``device_exchange.py``,
``column_plane.py``), which keep every shuffle on the host wire. The
device mesh and its collectives wait for the multi-device slice (ROADMAP
item A9).
"""
