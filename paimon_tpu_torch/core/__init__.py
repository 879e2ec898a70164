"""Store internals: key-value batches, merge executor, data files,
schema/snapshot/manifest metadata, commit, scan, read and write (port of
paimon_tpu/core)."""
