"""Workers of ``tests/test_torch_scaleout.py`` and ``tests/test_torch_grid.py``:
each runs in a spawned process and imports only torch and howl_tpu_torch (no
jax). Every group joins on a free port with a rendezvous timeout, and
``spawn_ranks`` joins its processes within a limit, so a hung rendezvous
fails its test."""

import os
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 90.0
SWEEP_KEY = 9  # seed s of a sweep steps at key SWEEP_KEY + s: both seeds' draws replace rows on both halves


def _to_numpy(tree):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), [_to_numpy(x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(x) for x in tree)
    return tree


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[0], type):
        return tree[0](*(_to_torch(x) for x in tree[1]))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(x) for x in tree)
    return tree


def host_draws(draws):
    """A ``StepDraws`` as picklable numpy (its NamedTuple types kept)."""
    return _to_numpy(draws)


def port_step(variables, cfg, audio, labels, bank, draws, group=None):
    """One SGD step of the port's classification step from JAX-layout
    ``variables``; with a group, on this rank's rows. Returns (loss,
    {name: numpy} of the model's state dict)."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.parallel.mesh import shard_batch
    from howl_tpu_torch.training.state import create_train_state
    from howl_tpu_torch.training.step import make_classification_train_step

    model = create_model("res8", num_labels=4)
    state = create_train_state(model, 1e-2, variables=variables, device="cpu")
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=1e-2)
    step = make_classification_train_step(model, cfg, None if bank is None else torch.from_numpy(bank), group=group)
    if group is not None:
        audio, labels = shard_batch((audio, labels), group)
    else:
        audio, labels = torch.from_numpy(audio), torch.from_numpy(labels)
    _, metrics = step(state, audio, labels, None, 7, draws=_to_torch(draws))
    return float(metrics["loss"]), {k: v.float().numpy().copy() for k, v in state.model.state_dict().items()}


def dp_step_rank(rank, size, address, queue, variables, cfg, audio, labels, bank, draws):
    from howl_tpu_torch.parallel import data_parallel

    torch.set_num_threads(1)
    with data_parallel.joined(rank, size, "cpu", address, TIMEOUT_S) as group:
        out = port_step(variables, cfg, audio, labels, bank, draws, group)
    queue.put((rank, out))


def sweep_step(variables: list, cfg, audio, labels, bank, draws, group=None, device="cpu"):
    """One SGD step of the port's seed sweep on ``device`` from JAX-layout
    ``variables`` (one a seed) on (S, B, n) ``audio`` and (S, B) ``labels``
    with each seed's global ``draws`` (host, or None); with a grid rank's
    seed group, seed ``group.seed`` on the rank's rows, on the group's
    device. Returns ([loss a seed], [{name: numpy} of each seed's state
    dict])."""
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.tf32 import exact_float32
    from howl_tpu_torch.parallel import create_seed_states, make_seed_sweep_step, shard_seed_batch
    from howl_tpu_torch.training.step import make_classification_train_step

    seeds = [group.seed] if group is not None else list(range(len(variables)))
    device = group.device if group is not None else torch.device(device)
    model = create_model("res8", num_labels=4)
    states = create_seed_states(model, seeds, variables=[variables[s] for s in seeds], device=device,
                                learning_rate=1e-2)
    for state in states:
        state.optimizer = torch.optim.SGD(state.model.parameters(), lr=1e-2)
    step = make_seed_sweep_step(make_classification_train_step(
        model, cfg, None if bank is None else torch.from_numpy(bank).to(device), group=group))
    batch = shard_seed_batch((audio[seeds], labels[seeds]), device, group=group)
    draws = None if draws is None else [_to_device(_to_torch(draws[s]), device) for s in seeds]
    with exact_float32():  # float32 products without TF32 on a card, in every rank's process
        _, metrics = step(states, *batch, None, [SWEEP_KEY + s for s in seeds], draws=draws)
    return ([float(x) for x in metrics["loss"]],
            [{k: v.float().cpu().numpy().copy() for k, v in state.model.state_dict().items()} for state in states])


def _to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    return tree


def card_grid_rank(rank, size, address, queue, variables, case):
    """A rank of a (seed 2, data size / 2) grid whose ranks share ``cuda:0``
    over gloo: ``sweep_step`` on its rows and its K3 launches."""
    from howl_tpu_torch.ops.augment_cuda import mix_noise_bank_cuda
    from howl_tpu_torch.parallel import data_parallel

    with data_parallel.joined(rank, size, "cuda:0", address, TIMEOUT_S, "gloo", seeds=2) as group:
        out = sweep_step(variables, *case, group=group)
        torch.cuda.synchronize()
    queue.put((rank, (out, mix_noise_bank_cuda.launches)))


def grid_rank(rank, size, address, queue, variables, cases, gsc_env, gsc_argv):
    """A rank of a (seed 2, data size / 2) grid: ``sweep_step`` on its rows
    for each case (cfg, audio, labels, bank, draws), then ``pretrain_gsc``
    in the grid with ``gsc_env`` set. Puts (the steps, the run's result,
    its step and epoch losses)."""
    from howl_tpu_torch.parallel import data_parallel
    from howl_tpu_torch.settings import SETTINGS
    from howl_tpu_torch.training.run import pretrain_gsc
    from howl_tpu_torch.training.run.train import LoopStats

    torch.set_num_threads(1)
    with data_parallel.joined(rank, size, "cpu", address, TIMEOUT_S, seeds=2) as group:
        steps = [sweep_step(variables, *case, group=group) for case in cases]
        os.environ.update(gsc_env)
        SETTINGS.reset()
        stats = LoopStats()
        out = pretrain_gsc.run(gsc_argv, stats)
    queue.put((rank, (steps, out, stats.step_losses, stats.epoch_losses)))


def spawn_ranks(target, size: int, *args, timeout_s: float = TIMEOUT_S) -> dict:
    """``target(rank, size, address, queue, *args)`` in ``size`` spawned
    processes on a free port; returns {rank: what it put on the queue}. A
    process still alive after ``timeout_s`` is killed and fails the call."""
    import multiprocessing as mp
    import queue as queue_mod

    from howl_tpu_torch.parallel.data_parallel import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, size, address, q, *args)) for r in range(size)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(size):
            rank, value = q.get(timeout=timeout_s)
            out[rank] = value
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * size and len(out) == size, f"ranks exited {codes} with results from {sorted(out)}"
    return out


def ws_files(path: Path) -> list:
    return sorted(str(p.relative_to(path)) for p in path.rglob("*") if p.is_file())


def evaluator_pieces(corpus: Path, state_dict: dict):
    """The port's pooled dev+test clips of ``corpus`` and an engine of
    ``state_dict`` (tests/test_train_dp.py's evaluator setup, one word)."""
    from howl_tpu_torch.context import InferenceContext
    from howl_tpu_torch.data.dataset.dataset_loader import WakeWordDatasetLoader
    from howl_tpu_torch.inference import EngineConfig, StreamingEngine
    from howl_tpu_torch.models import create_model
    from howl_tpu_torch.ops.frontend import FrontendConfig

    ctx = InferenceContext(vocab=["hey", "fire", "fox"], token_type="word", use_blank=False)
    _, dev, test = WakeWordDatasetLoader().load_splits(corpus, sample_rate=16000, mono=True,
                                                       frame_labeler=ctx.labeler)
    dev.extend(test)  # one pool, mixed lengths
    cfg = EngineConfig(inference_sequence=(0,), max_window_size_ms=500.0, eval_stride_size_ms=62.5,
                       negative_label=ctx.negative_label, num_labels=ctx.num_labels)
    model = create_model("res8", num_labels=ctx.num_labels)
    return dev, StreamingEngine(model, state_dict, cfg, FrontendConfig(n_mels=40), device="cpu")


def evaluate(evaluator, dataset, thresholds) -> tuple:
    conf, errors, ms = evaluator.evaluate(dataset, positive_set=True)
    sweep, _ = evaluator.evaluate_sweep(dataset, True, thresholds)
    return ((conf.tp, conf.tn, conf.fp, conf.fn), errors, ms,
            {t: (c.tp, c.tn, c.fp, c.fn) for t, c in sweep.items()}, evaluator.batches)


def evaluator_rank(rank, size, address, queue, corpus, state_dict, thresholds):
    from howl_tpu_torch.parallel import data_parallel
    from howl_tpu_torch.training.run.train import BatchedEvaluator

    torch.set_num_threads(1)
    with data_parallel.joined(rank, size, "cpu", address, TIMEOUT_S) as group:
        dataset, engine = evaluator_pieces(corpus, state_dict)
        out = evaluate(BatchedEvaluator(engine, max_batch=4, group=group), dataset, thresholds)
    queue.put((rank, out))
