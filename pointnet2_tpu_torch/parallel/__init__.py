"""Multi-process data parallelism of the port: the mesh of ranks
(``mesh``), the host-side helpers (``multihost``) and the launcher
(``launch``)."""
