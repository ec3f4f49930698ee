"""Multi-process training: process groups, meshes, the data-parallel and
FSDP helpers (``parallel.mesh``), the process launcher (``parallel.launch``)
and the multi-device dry run (``parallel.dryrun``). Import the module you
need; the package imports none of them."""
