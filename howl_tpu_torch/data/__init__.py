"""Data model, datasets, corpus loaders, dataset writers and host-side batch
sampling (counterpart of ``howl_tpu/data``). The dataset ETL lives in
``howl_tpu_torch/etl`` and the aligners in ``howl_tpu_torch/align``."""
