"""Training (counterpart of ``howl_tpu/training``): the train state, the
objectives and the train and eval steps. The training entry point, datasets
and checkpoints are not ported yet (ROADMAP Queue 1, item 7)."""
