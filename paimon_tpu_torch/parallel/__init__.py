"""The parallel layer (port of paimon_tpu/parallel/; so far only the
pipeline configuration the writer's flush offload reads)."""
