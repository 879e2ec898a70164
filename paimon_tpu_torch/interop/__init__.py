"""The reference's on-disk layouts (port of the parts of
paimon_tpu/interop/ the Avro manifests need): the BinaryRow byte layout,
the generic Avro object-container codec, the manifest schemas and the
manifest record mapping."""
