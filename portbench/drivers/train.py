"""Training cells: AEC pretraining (`train.train_aec`) or DEC refinement
(`train.train_dec`) of the port over windows made in set-up, as the
workflow's `_train_aec_run` / `_train_dec_run` call them (the per-epoch
snapshot in the run's TMPDIR; no TensorBoard, no figures).

Set-up makes the windows (a DAS waveform through the port's STFT, K1, or
the RIS catalog's events), normalises and batches them, draws the
weights, builds the train state, and drives it through its first steps
with one call of the window's own: `epochs_per_call` epochs over the
whole training set and validation set, the batches and the feed that the
window then steps through. That call also warms up every shape, and the
first Adam step's one-time imports. Hooks on the optimizer and the model
keep the first step's gradients (Adam's first moment over 1 - b1), each
of the first steps' forward outputs, the parameters after the third step
and, for DEC, the q of the full eval that starts the call, from the
initial weights and centroids. The same state then trains in the window,
in whole calls of `epochs_per_call`, until `--seconds` have passed.

After the window the reference follows the first three steps from the
same weights on its own windows (float64 STFT and normalisation), and
for DEC works out the starting full eval again from the same weights and
centroids.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import sys
import tempfile

import torch

from portbench import compare, harness, roofline, trace
from portbench.reference import network, split
from portbench.reference import stft as ref_stft
from portbench.reference.train import follow, matmul_precision
from portbench.traffic import events, waveform

FIRST_STEPS = 3


class Recorder:
    """Hooks on the optimizer and the model: the first step's gradients,
    the batches and outputs of the first three training forwards, the
    parameters after step 3 and (DEC) the q of the no-grad forwards
    before the first training forward, which are the full eval that
    starts a DEC call."""

    def __init__(self, model, optimizer):
        self.names = {p: n for n, p in model.named_parameters()}
        self.model = model
        self.steps = 0
        self.grads, self.params3 = {}, None
        self.inputs, self.outputs, self.q_chunks = [], [], []
        self._hooks = [optimizer.register_step_post_hook(self._after_step),
                       model.register_forward_hook(self._forward)]

    def _params(self):
        return {n: p.detach().clone() for n, p in
                self.model.named_parameters()}

    def _after_step(self, optimizer, args, kwargs):
        self.steps += 1
        if self.steps == 1:
            b1 = optimizer.param_groups[0]["betas"][0]
            self.grads = {self.names[p]: s["exp_avg"].detach() / (1 - b1)
                          for p, s in optimizer.state.items()}
        if self.steps == FIRST_STEPS:
            self.params3 = self._params()

    def _forward(self, module, inputs, out):
        if not torch.is_grad_enabled():
            if not self.outputs:
                self.q_chunks.append(out[0].detach().clone())
        elif len(self.outputs) < FIRST_STEPS:
            self.inputs.append(inputs[0].detach().clone())
            self.outputs.append(tuple(o.detach().clone() for o in out))

    def close(self):
        for h in self._hooks:
            h.remove()
        if self.params3 is None:  # fewer steps ran than were asked for
            self.params3 = self._params()


def _windows(ctx, gen):
    """(raw windows (M, H, W, 1) on the device, the input they came
    from): the DAS waveform through the port's STFT, or the catalog."""
    from spectrogram_cube_clustering_tpu_torch.signal.stft import (
        spectrogram_windows,
    )

    cfg, prm = ctx.config, ctx.params
    if prm["source"] == "waveform":
        wave = waveform.training_waveform(tuple(prm["waveform"]), gen,
                                          ctx.device, prm["amplitude"])
        stft = cfg["stft"]
        raw = spectrogram_windows(wave, nperseg=stft["nperseg"],
                                  hop=stft["hop"],
                                  window_rows=stft["window_rows"],
                                  transform=None)
        return raw, wave
    dump, _ = events.catalog_dump(prm["events"], gen, ctx.device)
    return dump, dump


def _reference_windows(ctx, source, dtype):
    """The reference's normalised windows (M, H, W, 1) in `dtype`."""
    cfg = ctx.config
    norm = ref_stft.NORMALIZERS[cfg["transform"]]
    if ctx.params["source"] == "waveform":
        s = cfg["stft"]
        spec = ref_stft.log_power(source, s["nperseg"], s["hop"], dtype)
        return norm(ref_stft.windows(spec, s["window_rows"]))
    return norm(source.to(dtype))


def _initial_clusters(ctx, source, w0, gen):
    """DEC's initial (labels, centroids), made by the harness and handed
    to both sides: the centroids are the latents of K windows drawn from
    the seed (k-means++'s first pick, without its iterations), worked out
    by the reference in float64 from the initial weights; the labels are
    uniform draws, the previous labels of the first refresh only."""
    k = ctx.config["n_clusters"]
    x = _reference_windows(ctx, source, torch.float64)
    pick = torch.randperm(len(x), generator=gen, device=x.device)[:k]
    z = network.encode({n: v.double() for n, v in w0.items()}, x[pick])
    labels = torch.randint(0, k, (len(x),), generator=gen, device=x.device)
    return labels, z.float()


def run(ctx) -> dict:
    from spectrogram_cube_clustering_tpu_torch import train
    from spectrogram_cube_clustering_tpu_torch.data.cube import (
        train_val_split,
    )
    from spectrogram_cube_clustering_tpu_torch.models.build import (
        build_model,
    )
    from spectrogram_cube_clustering_tpu_torch.ops.normalize import (
        make_normalizer,
    )

    cfg, prm, dev = ctx.config, ctx.params, ctx.device
    hw = tuple(cfg["input_hw"])
    dec = prm["model"] == "DEC"
    k = cfg["n_clusters"] if dec else 0
    bsz, lr = prm["batch_size"], prm["lr"]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    tmp = tempfile.mkdtemp(prefix="portbench_")
    snap = os.path.join(tmp, "SNAPSHOT")
    try:
        ctx.note("imports and the card's first use")
        raw, source = _windows(ctx, gen)
        ctx.note("windows")
        w0 = harness.seeded_weights(network.param_shapes(hw, k), gen, dev)
        labels0 = None
        if dec:
            harness.scale_latent_head(w0, prm["latent_head_scale"])
            # the reference's work, handed to both sides: not set-up
            t_ref = ctx.clock.now()
            labels0, w0["clustering.weights"] = _initial_clusters(
                ctx, source, w0, gen)
            harness.sync(dev)
            ctx.exclude_from_setup(ctx.clock.now() - t_ref)
        if ctx.mode == "control":
            return _control(ctx, source, w0)

        # ------------------------------------------------ the program
        norm = make_normalizer(cfg["transform"])
        if dec:
            tra, val = norm(raw), None
        else:
            idx_tra, idx_val = (torch.from_numpy(i).to(dev)
                                for i in train_val_split(len(raw)))
            tra, val = norm(raw[idx_tra]), norm(raw[idx_val])
        del raw
        model = build_model("DEC" if dec else "AEC", "AEC", hw,
                            cfg["attention_faithful"], k or None,
                            device=dev)
        model.load_state_dict(w0)
        state = train.create_train_state(model, lr)
        tra_b = train.make_batched_data(tra, bsz)
        val_b = train.make_batched_data(val, bsz) if val is not None else None
        m = len(tra)
        if dec and max(math.ceil(m / (2 * bsz)), 1) <= FIRST_STEPS:
            raise ValueError(
                f"the first refresh falls among the first {FIRST_STEPS} "
                "steps, which the reference follows with the initial target")
        rec = Recorder(model, state.optimizer)
        ctx.note("model, state and batches")

        def ckpt(name, params):
            torch.save(params, os.path.join(tmp, f"{name}.pt"))

        epochs = prm["epochs_per_call"]
        if dec:
            initial = [labels0, w0["clustering.weights"].clone()]

            def call(epochs):
                out = train.train_dec(
                    model, state, tra_b,
                    train.DECConfig(n_clusters=k, n_epochs=epochs,
                                    gamma=prm["gamma"], tol=prm["tol"],
                                    update_interval=prm["update_interval"],
                                    init="load"),
                    initial=tuple(initial), snapshot_path=snap)
                initial[:] = [torch.as_tensor(out["labels"], device=dev),
                              torch.as_tensor(out["centroids"], device=dev)]
                # the initial full eval and each refresh: one forward of
                # every window
                return out, epochs * m, (len(out["deltas"]["delta"]) + 1) * m

            out, _, _ = call(epochs)
            hist = out["history"]
            prog_losses = [_unrun(hist["total"], i) for i in range(FIRST_STEPS)]
            prog_kl = [_unrun(hist["clustering"], i)
                       for i in range(FIRST_STEPS)]
            del out, hist
        else:
            def call(epochs):
                out = train.train_aec(
                    model, state, tra_b, val_b,
                    train.AECConfig(n_epochs=epochs, early_stopping=False),
                    save_checkpoint=ckpt, snapshot_path=snap)
                return out, epochs * tra_b.n_samples, epochs * val_b.n_samples

            call(epochs)
            # each step's loss: the mean squared error of the program's
            # reconstruction of the real rows of its batch
            prog_losses = [
                float(torch.mean((o[0][:n].double() - x[:n].double()) ** 2))
                for x, o, n in zip(rec.inputs, rec.outputs,
                                   tra_b.counts.long().tolist())]
            prog_kl = None
        rec.close()
        harness.sync(dev)
        ctx.note("first steps")
        # what only the comparison reads leaves the card before the window,
        # so that the window's peak is the program's own: not set-up
        t_ref = ctx.clock.now()
        prog = {"windows": tuple(None if t is None else t.cpu()
                                 for t in (tra, val)),
                "losses": prog_losses, "kl": prog_kl,
                "grads": rec.grads, "params3": rec.params3,
                "recon": (rec.outputs[0][1 if dec else 0].cpu()
                          if rec.outputs else None),
                "q0": torch.cat(rec.q_chunks).cpu() if rec.q_chunks else None}
        source = source.cpu()
        del tra, val, rec
        ctx.exclude_from_setup(ctx.clock.now() - t_ref)

        # ------------------------------------------------- the window
        harness.reset_peak(dev)
        t0 = ctx.clock.now()
        ctx.window_started(t0)
        samples = forwards = steps = 0
        calls = []
        while True:
            _, s, f = call(epochs)
            calls.append(ctx.clock.now())
            samples += s
            forwards += f
            steps += epochs * tra_b.n_batches
            if ctx.clock.now() - t0 >= ctx.seconds:
                break
        harness.sync(dev)
        window_s = ctx.clock.now() - t0
        peak = harness.peak_bytes(dev)
        print("portbench: calls end at " + ", ".join(
            f"{t - t0:.3f}" for t in calls) + " s", file=sys.stderr)

        slice_data = None
        if ctx.trace:
            with trace.Slice(dev) as sl:
                _, s, _ = call(1)
            slice_data = {"summary": sl.summary, "samples": s}
        del model, state, tra_b, val_b, call
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---------------------------------------------- the reference
        compared = _reference(ctx, source.to(dev), w0, prog)
        flops = (samples * roofline.train_flops(hw, k)
                 + forwards * roofline.forward_flops(hw, k))
        return {
            "end_to_end": {
                "train_samples_per_s": samples / window_s,
                "peak_device_mib": peak / 2 ** 20,
            },
            "data": {"window_s": window_s, "samples": samples,
                     "flops": flops, "slice": slice_data},
            "compared": compared,
            "attempted": steps,
            "failed": 0,
            "peak_bytes": peak,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _unrun(running, i):
    """Step i's loss from the history's running means of equal batches."""
    return (i + 1) * running[i] - i * running[i - 1] if i else running[0]


def _first_batches(ctx, x, p=None):
    """The first steps' batches of the reference's training windows."""
    bsz = ctx.params["batch_size"]
    out = []
    for i in range(FIRST_STEPS):
        xb = x[i * bsz:(i + 1) * bsz]
        mask = torch.ones(len(xb), dtype=x.dtype, device=x.device)
        out.append((xb, mask) if p is None
                   else (xb, mask, p[i * bsz:(i + 1) * bsz]))
    return out


def _loss_fn(ctx):
    hw = tuple(ctx.config["input_hw"])
    if ctx.params["model"] == "DEC":
        gamma = ctx.params["gamma"]
        return lambda prm, b: network.dec_loss(prm, b[0], b[1], b[2], gamma,
                                               hw)
    return lambda prm, b: network.aec_loss(prm, b[0], b[1], hw,
                                           with_output=True)


def _steps(ctx, x_all, w, dtype):
    """The reference's first steps over its windows in `dtype`; for DEC
    with the target from the full eval at the start, whose q it keeps."""
    if ctx.params["model"] == "DEC":
        q0, _ = network.dec_outputs({k: v.to(dtype) for k, v in w.items()},
                                    x_all)
        p = network.target(torch.round(q0, decimals=5))
        ref = follow(w, _first_batches(ctx, x_all, p), _loss_fn(ctx),
                     ctx.params["lr"], dtype)
        ref["q0"] = q0
        return ref
    idx, _ = split.train_val_split(len(x_all))
    tra = x_all[torch.from_numpy(idx).to(x_all.device)]
    return follow(w, _first_batches(ctx, tra), _loss_fn(ctx),
                  ctx.params["lr"], dtype)


def _split_windows(ctx, x_all):
    if ctx.params["model"] == "DEC":
        return x_all, None
    idx_tra, idx_val = (torch.from_numpy(i).to(x_all.device)
                        for i in split.train_val_split(len(x_all)))
    return x_all[idx_tra], x_all[idx_val]


def _per_step(gap, prog, ref) -> float:
    """The worst of the first steps' gaps; a step the program did not
    run reads as infinite."""
    if prog is None or len(prog) < FIRST_STEPS:
        return math.inf
    return max(gap(p, r) for p, r in zip(prog, ref))


def _gaps(ctx, prog, ref, keep) -> list:
    """[(name, value)] of the first steps, and of DEC's starting eval."""
    out = [("windows_gap", max(
        compare.max_abs_gap(a, b) for a, b in zip(prog["windows"], ref["windows"])
        if b is not None))]
    out.append(("loss_gap", _per_step(
        lambda p, r: compare.rel_gap(p, r[0]), prog["losses"],
        ref["losses"])))
    if ctx.params["model"] == "DEC":
        out.append(("kl_gap", _per_step(
            lambda p, r: compare.rel_gap(p, r[2]), prog["kl"],
            ref["losses"])))
        out.append(("refresh_q_gap", math.inf if prog["q0"] is None
                    else compare.max_abs_gap(prog["q0"], ref["q0"])))
    else:  # the first step's forward, element by element
        first = ref["losses"][0][1]
        out.append(("recon_gap", math.inf if prog["recon"] is None else
                    compare.rel_max_gap(prog["recon"][:len(first)], first)))
    out.append(("grad_gap", compare.leaf_norm_gap(prog["grads"], ref["grads"])))
    d_prog = compare.change(prog["params3"], ref["w0"])
    d_ref = compare.change(ref["params"], ref["w0"])
    out.append(("change_gap", compare.leaf_norm_gap(d_prog, d_ref, keep)))
    out.append(("change_gap_median", statistics.median(
        compare.leaf_gaps(d_prog, d_ref, keep).values())))
    print("portbench: worst leaves: gradient "
          f"{compare.worst_leaf(prog['grads'], ref['grads'])}, change "
          f"{compare.worst_leaf(d_prog, d_ref, keep)}; left out of the "
          f"change: {sorted(set(ref['grads']) - set(keep)) or 'none'}",
          file=sys.stderr)
    return out


def _limits(ctx, gaps) -> list:
    return [(n, v, ctx.limits.get(n)) for n, v in gaps]


def _reference(ctx, source, w0, prog) -> list:
    x_all = _reference_windows(ctx, source, torch.float64)
    ref = _steps(ctx, x_all, w0, torch.float64)
    ref["windows"] = _split_windows(ctx, x_all)
    ref["w0"] = w0
    return _limits(ctx, _gaps(ctx, prog, ref,
                              compare.moving_leaves(ref["grads"])))


def _control(ctx, source, w0) -> dict:
    """The reference in the program's place one precision below it: the
    STFT in float32, the network in float32 with TF32 on. No window."""
    dec = ctx.params["model"] == "DEC"
    with matmul_precision(True):
        x_c = _reference_windows(ctx, source, torch.float32)
        ctl = _steps(ctx, x_c, w0, torch.float32)
    prog = {"windows": _split_windows(ctx, x_c),
            "losses": [r[0] for r in ctl["losses"]],
            "kl": [r[2] for r in ctl["losses"]] if dec else None,
            "recon": None if dec else ctl["losses"][0][1],
            "q0": ctl.get("q0"),
            "grads": ctl["grads"], "params3": ctl["params"]}
    return {"end_to_end": {}, "data": {},
            "compared": _reference(ctx, source, w0, prog),
            "attempted": 0, "failed": 0, "peak_bytes": 0}
