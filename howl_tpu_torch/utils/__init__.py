"""Shared host utilities (counterpart of ``howl_tpu/utils``): logging,
hashing, audio I/O, registries, argparse glue, worker pools and the
TensorBoard event writer. Pure Python and numpy; nothing here touches the
device."""
