"""Data parallelism (counterpart of ``lpr_tpu/parallel``): the mesh of
replicas, the process group from the launcher's environment, and the
collectives the trainers call."""
