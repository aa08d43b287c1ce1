"""Data model, datasets and host-side batch sampling (counterpart of
``howl_tpu/data``). The ETL generators and the GSC / Common Voice / Hey Snips
loaders are not ported yet (ROADMAP Queue 1, item 12)."""
