"""The training program: epochs, validation, reports, checkpoints, resume.

The port of ``mudiff_tpu/train/loop.py`` (reference ``train_mudiff``,
engine/train.py:386-1242), on one device or on a mesh of processes
launched by torchrun (``parallel/mesh.py``).  What a user observes is the
JAX loop's:

* ``num_channels`` is forced to 1 (slice data); ``train_config.json``
  records the config and the git commit;
* each iteration is a D step, lazy R1 when ``global_step % lazy_reg ==
  0`` (``global_step`` is restored on resume), then a G step;
* a ``[TRAIN]`` line every ``log_every`` iterations with the losses and
  the ``StepTimer`` window and data-wait times;
* after each epoch: a preview grid ``sample_epoch_<e>.png`` every 10
  epochs and at the last, validation by full T-step sampling with the
  non-EMA generators over the ``pad_last`` val batches (L1 and PSNR in
  [0, 1]), ``val_l1_loss.npy`` / ``val_psnr_values.npy`` of shape
  (num_epoch + 1, val batches), ``training_history.json`` and the
  collage (``epoch_visual_report``);
* ``content.pt`` every ``save_content_every`` epochs and the generator
  files every ``save_ckpt_every`` epochs and at the last;
* ``--resume`` continues from ``content.pt`` at the next epoch;
  ``pretrained_dir`` warm-starts G1 and G2;
* SIGTERM / SIGINT: the current iteration ends, ``content.pt`` is
  written, the old handlers come back and ``train`` returns with
  ``"preempted": True``.

The random draws come from one ``torch.Generator`` on the device, seeded
with ``config.seed`` at every start (the JAX key also restarts from the
seed on a resume); the loader's order from ``seed + epoch``.  Validation
samples under ``torch.no_grad()`` (not inference mode), so nothing a
module caches there is an inference tensor at the next training step.
``use_int8`` is ignored in training, as in the JAX package.

On a mesh every rank runs the same loop (the JAX package's SPMD
discipline, ``loop.py:55-67``): the global batch is ``batch_size x dp``,
each rank loads its rows of it (``DeviceLoader``), and the draws are the
global batch's, sliced.  Preview and validation sample the rank's rows
and gather the fakes and reals over the data group, so L1 and PSNR are
the global batch's, as ``_host_value`` gives them (``:42-53``).
Checkpoints are written by the lead rank after a gather on every rank.
Only the lead rank writes ``train_config.json``, the history, the PNGs
and the ``.npy`` arrays, and logs.  A SIGTERM is agreed over the ranks at
the log cadence (``any_rank``, as ``_stop_agreed`` does, ``:214-226``),
so every rank saves and stops at the same step.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import GENERATOR_FILES
from mudiff_torch.data import BRATS_ORDERS, ISLES_ORDERS, DeviceLoader, SliceDataset
from mudiff_torch.diffusion.sampling import sample_from_model, sampler_draws
from mudiff_torch.metrics import psnr as psnr_fn
from mudiff_torch.parallel.mesh import Mesh, any_rank, gather_rows, mesh_shape, rows_of
from mudiff_torch.sampler import serving_device
from mudiff_torch.train import checkpoint as ckpt
from mudiff_torch.train.state import TrainState, create_train_state
from mudiff_torch.train.steps import TrainDraws, make_d_step, make_g_step
from mudiff_torch.utils.profiling import StepTimer, device_memory_stats, maybe_profile
from mudiff_torch.utils.reports import epoch_visual_report, save_image_grid

class SeededDraws:
    """The loop's random numbers, from one ``torch.Generator`` on ``device``
    seeded with ``config.seed``: per iteration the D step's then the G
    step's ``TrainDraws``; per sampling call ``x_init`` then each step's
    ``(z, posterior noise)``, the sampler's order.  On a ``mesh`` each is
    drawn for the global batch and this rank's rows are kept."""

    def __init__(self, config: MuDiffConfig, device, mesh: Optional[Mesh] = None):
        self.config = config
        self.mesh = mesh
        self.generator = torch.Generator(device).manual_seed(config.seed)

    def iteration(self, real: torch.Tensor) -> Tuple[TrainDraws, TrainDraws]:
        return (TrainDraws.draw(self.config, real, self.generator, self.mesh),
                TrainDraws.draw(self.config, real, self.generator, self.mesh))

    def sample(self, real: torch.Tensor) -> Tuple[torch.Tensor, List]:
        n = real.shape[0] * (self.mesh.dp if self.mesh is not None else 1)
        return sampler_draws(self.generator, (n, *real.shape[1:]), self.config.nz,
                             self.config.num_timesteps, rows_of(n, self.mesh))


def _to_range_0_1(x: np.ndarray) -> np.ndarray:
    return (x + 1.0) / 2.0


def _git_commit() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(config: MuDiffConfig, verbose: bool = True, *, device=None, attn: str = "einsum",
          state: Optional[TrainState] = None, draws=None,
          profile_dir: Optional[str] = None, mesh: Optional[Mesh] = None) -> Dict:
    """Run the training job on one device (default the card) or, with a
    ``mesh`` (``parallel.init_mesh``; every rank calls ``train``), on the
    mesh's device of each rank; returns the paths of what it wrote,
    ``r1_steps`` (the global steps whose D step ran R1) and ``timings``
    (host seconds: each iteration's, the data wait and the logging
    windows, each epoch's, each validation's and preview's, each save's,
    the restore's).  ``config.dp`` / ``config.fsdp`` must resolve to the
    mesh's shape (without a mesh, to one process).

    ``attn`` is the generators' attention lowering (``"flash"``: kernel
    K3 and its backward).  Seams for tests: ``state``, an initial
    ``TrainState`` for this config (as ``create_train_state`` with the
    loader's steps per epoch would build it); ``draws``, a source with
    ``iteration(real) -> (TrainDraws, TrainDraws)`` and ``sample(real) ->
    (x_init, noise)`` (default ``SeededDraws``).  ``profile_dir`` traces
    global steps 10-14 with torch.profiler there.
    """
    shape = mesh_shape(config.dp, config.fsdp, mesh.world if mesh is not None else 1)
    if mesh is not None and shape != (mesh.dp, mesh.fsdp):
        raise ValueError(f"dp={config.dp}, fsdp={config.fsdp} resolve to {shape}, the mesh is "
                         f"{mesh.dp}x{mesh.fsdp}")
    device = mesh.device if mesh is not None else serving_device(device, "train")
    lead = mesh is None or mesh.lead
    n_data = mesh.dp if mesh is not None else 1
    log = print if verbose and lead else (lambda *a, **k: None)
    exp_dir = os.path.join(config.output_path, config.exp, config.target_modality)
    os.makedirs(exp_dir, exist_ok=True)

    # slice data is single-channel (reference engine/train.py:465)
    if config.num_channels != 1:
        log(f"[config] overriding num_channels={config.num_channels} -> 1 "
            "(slice data is single-channel; reference engine/train.py:465)")
        config = config.replace(num_channels=1)
    config = config.replace(use_int8=False)  # parsed, ignored in training

    if lead:
        prov = {"config": config.to_dict(), "git_commit": _git_commit()}
        with open(os.path.join(exp_dir, "train_config.json"), "w") as f:
            json.dump(prov, f, indent=2, default=str)

    # ---- data ------------------------------------------------------------
    orders = ISLES_ORDERS if config.dataset == "isles" else BRATS_ORDERS
    ds_train = SliceDataset("train", config.input_path, config.target_modality, orders=orders)
    ds_val = SliceDataset("val", config.input_path, config.target_modality, orders=orders)
    global_batch = config.batch_size * n_data
    data_index = mesh.data_index if mesh is not None else 0
    loader = DeviceLoader(ds_train, global_batch, shuffle=True, seed=config.seed,
                          device=device, process_index=data_index, process_count=n_data)
    loader_val = DeviceLoader(ds_val, global_batch, shuffle=False, seed=config.seed,
                              pad_last=True, device=device, process_index=data_index,
                              process_count=n_data)
    steps_per_epoch = max(1, len(loader))
    log(f"train data size: {len(loader)}")
    log(f"val data size: {len(loader_val)}")
    log(f"target modality: {config.target_modality}")
    log(f"device: {device}  mesh: data={n_data} fsdp={shape[1]}  "
        f"global batch: {global_batch}")

    if state is None:
        state = create_train_state(config, seed=config.seed, steps_per_epoch=steps_per_epoch,
                                   device=device, attn=attn, mesh=mesh)
    log(f"[MODEL] G1 params: {state.param_count('g1'):,}  G2: {state.param_count('g2'):,}  "
        f"D: {state.param_count('d'):,}")
    d_step, g_step = make_d_step(), make_g_step()
    draws = draws if draws is not None else SeededDraws(config, device, mesh)
    compute_dtype = torch.bfloat16 if config.use_bf16 else torch.float32

    def sample(c1, c2, c3, real):
        """Fakes and reals of the global batch, as numpy."""
        x_init, noise = draws.sample(real)
        state.materialize(("g1", "g2"))
        with torch.no_grad():  # the non-EMA generators, as the JAX loop
            fake = sample_from_model(state.pos_coeff, state.g1, state.g2, c1, c2, c3, x_init,
                                     config.num_timesteps, config.nz, noise=noise,
                                     compute_dtype=compute_dtype)
            return (gather_rows(fake, mesh).cpu().numpy(),
                    gather_rows(real, mesh).cpu().numpy())

    timings = {"iteration_s": [], "data_wait_s": 0.0, "window_s": 0.0, "epoch_s": [],
               "val_s": [], "preview_s": [], "content_save_s": [], "generators_save_s": [],
               "restore_s": None}
    r1_steps: List[int] = []

    # ---- resume / warm start -----------------------------------------------
    init_epoch, global_step = 0, 0
    if config.resume and os.path.isfile(os.path.join(exp_dir, ckpt.CONTENT_FILE)):
        t0 = time.time()
        state, init_epoch, global_step = ckpt.restore_content(exp_dir, state)
        _sync(device)
        timings["restore_s"] = time.time() - t0
        init_epoch += 1
        log(f"resumed from epoch {init_epoch - 1}, step {global_step}")
    elif config.pretrained_dir:
        for module, name in zip((state.g1, state.g2), GENERATOR_FILES):
            module.load_state_dict(ckpt.load_generator_params(config.pretrained_dir, name),
                                   strict=True)
        log(f"warm-started generators from {config.pretrained_dir}")

    # Preemption: on SIGTERM / SIGINT finish the iteration, save the
    # content and return, so --resume continues.
    stop_requested = {"flag": False}

    def on_term(signum, frame):
        stop_requested["flag"] = True
        log(f"[signal] {signal.Signals(signum).name} received — will checkpoint and stop "
            "at the next step boundary")

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_term)
        except ValueError:
            pass  # not the main thread

    def restore_handlers():
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    history_path = os.path.join(exp_dir, "training_history.json")
    val_l1 = np.zeros((config.num_epoch + 1, max(1, len(loader_val))))
    val_psnr = np.zeros_like(val_l1)

    try:
        timer = StepTimer()
        for epoch in range(init_epoch, config.num_epoch):
            ep_start = time.time()
            ep_losses: Dict[str, float] = {}
            ep_count = 0
            timer.reset()

            for it, batch in enumerate(loader.epoch(epoch)):
                timer.mark_data_ready()
                t_ready = time.time()
                d_draws, g_draws = draws.iteration(batch[3])
                with_r1 = config.lazy_reg is None or global_step % config.lazy_reg == 0
                if with_r1:
                    r1_steps.append(global_step)
                with maybe_profile(global_step, profile_dir if lead else None):
                    d_aux = d_step(state, batch, d_draws, with_r1)
                    g_aux = g_step(state, batch, g_draws)
                global_step += 1
                ep_count += 1

                # one process acts at once; ranks agree at the log cadence,
                # since the check itself is a collective
                if mesh is None or mesh.world == 1:
                    stop = stop_requested["flag"]
                else:
                    stop = bool(config.log_every and (it + 1) % config.log_every == 0
                                and any_rank(stop_requested["flag"], mesh))
                if stop:
                    t0 = time.time()
                    ckpt.save_content(exp_dir, state, epoch, global_step)
                    timings["content_save_s"].append(time.time() - t0)
                    log(f"[signal] content checkpoint saved at epoch {epoch}, step "
                        f"{global_step}; exiting")
                    return {"exp_dir": exp_dir, "history": history_path, "preempted": True,
                            "r1_steps": r1_steps, "timings": timings}

                if config.log_every and (it + 1) % config.log_every == 0:
                    metrics = {k: float(v) for k, v in {**d_aux, **g_aux}.items()}
                    for k, v in metrics.items():
                        ep_losses[k] = ep_losses.get(k, 0.0) + v
                    window = timer.window()
                    timings["window_s"] += window
                    timings["data_wait_s"] += timer.data_time
                    ips = config.log_every * global_batch / max(window, 1e-9)
                    log(f"[TRAIN] ep {epoch} it {it + 1}/{steps_per_epoch} "
                        f"G={metrics['G_total']:.4f} (adv {metrics['G_adv']:.4f} "
                        f"L1 {metrics['G_L1']:.4f} mask {metrics['G_mask']:.4f}) "
                        f"D={metrics['D_total']:.4f} R1={metrics['R1']:.4f} "
                        f"ips={ips:.1f} time(b/d)={window:.1f}/{timer.data_time:.1f}s "
                        f"bs={config.batch_size}x{n_data}")
                    if config.log_mem_after_update:
                        for dev, st in device_memory_stats().items():
                            log(f"[MEM] {dev}: in_use={st['bytes_in_use_gib']:.2f}GiB "
                                f"peak={st['peak_bytes_gib']:.2f}GiB")
                    timer.reset()
                timings["iteration_s"].append(time.time() - t_ready)
                timer.mark_step_done()

            # ---- per-epoch tail ---------------------------------------------
            _sync(device)
            epoch_time = time.time() - ep_start
            timings["epoch_s"].append(epoch_time)
            summary = ({k: v / max(1, ep_count // max(1, config.log_every))
                        for k, v in ep_losses.items()} if ep_losses else {})

            # preview grid every 10 epochs and at the last
            samples_np = real_np = None
            if epoch % 10 == 0 or epoch == config.num_epoch - 1:
                t0 = time.time()
                try:
                    preview_it = loader_val.epoch(0)  # one batch; close stops its thread
                    c1, c2, c3, real = next(preview_it)
                    preview_it.close()
                    samples_np, real_np = sample(c1, c2, c3, real)
                    if lead:
                        save_image_grid(_to_range_0_1(samples_np),
                                        os.path.join(exp_dir, f"sample_epoch_{epoch}.png"))
                except Exception as e:  # a preview never ends training
                    log(f"[WARN] preview sampling failed: {e}")
                timings["preview_s"].append(time.time() - t0)

            # validation: full T-step sampling over the val split
            t0 = time.time()
            vl1, vpsnr = [], []
            for vb, (c1, c2, c3, real) in enumerate(loader_val.epoch(0)):
                fake_np, real_np_v = sample(c1, c2, c3, real)
                f01, r01 = _to_range_0_1(fake_np), _to_range_0_1(real_np_v)
                l1 = float(np.mean(np.abs(f01 - r01)))
                p = psnr_fn(r01, f01, data_range=1.0)
                vl1.append(l1)
                vpsnr.append(p)
                if vb < val_l1.shape[1]:
                    val_l1[epoch, vb] = l1
                    val_psnr[epoch, vb] = p
            timings["val_s"].append(time.time() - t0)
            mean_l1 = float(np.mean(vl1)) if vl1 else float("nan")
            mean_psnr = float(np.mean(vpsnr)) if vpsnr else float("nan")
            log(f"[EPOCH {epoch}] time={epoch_time:.1f}s val_L1={mean_l1:.4f} "
                f"val_PSNR={mean_psnr:.2f} "
                + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))

            if lead:
                epoch_visual_report(exp_dir=exp_dir, epoch=epoch, losses=summary,
                                    val_l1=mean_l1, val_psnr=mean_psnr, epoch_time=epoch_time,
                                    samples=samples_np, reals=real_np,
                                    history_path=history_path)
                np.save(os.path.join(exp_dir, "val_l1_loss.npy"), val_l1)
                np.save(os.path.join(exp_dir, "val_psnr_values.npy"), val_psnr)

            # checkpoints
            if config.save_content and epoch % config.save_content_every == 0:
                t0 = time.time()
                ckpt.save_content(exp_dir, state, epoch, global_step)
                timings["content_save_s"].append(time.time() - t0)
            if epoch % config.save_ckpt_every == 0 or epoch == config.num_epoch - 1:
                t0 = time.time()
                ckpt.save_generators(exp_dir, state, epoch=epoch,
                                     use_ema_weights=config.use_ema)
                timings["generators_save_s"].append(time.time() - t0)
    finally:
        restore_handlers()
    return {"exp_dir": exp_dir, "history": history_path, "r1_steps": r1_steps,
            "timings": timings}
