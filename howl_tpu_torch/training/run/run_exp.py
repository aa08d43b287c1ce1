"""Alias of ``eval_wake_word_detection`` (counterpart of
``howl_tpu/training/run/run_exp.py``; the reference keeps run_exp.py as a
near-duplicate predecessor, training/run/run_exp.py:319; one implementation
here)."""

from howl_tpu_torch.training.run.eval_wake_word_detection import main, run  # noqa: F401

if __name__ == "__main__":
    main()
