#!/usr/bin/env python
"""Where the port's full-width training segment leaves the JAX training
golden, and why: which parameter elements the first Adam update moves in
opposite directions, and which BN running statistics differ most after
three windows.

  python tools/train_golden_drift.py jax    # JAX on the CPU, ~2 min
  python tools/train_golden_drift.py port [--devices cpu,cuda]
  python tools/train_golden_drift.py disc   # JAX and torch on the CPU

`jax` reruns the golden's JAX segments (`make_torch_train_golden.
jax_segments` on FULL_SPEC), checks that they reproduce the committed
golden bit for bit, and writes what the golden leaves out to
`build/train_golden_drift/jax.npz`: after K = 1 and K = 3 windows the full
discriminator params and state, and for each generator element the
direction of its K = 1 update and whether it moved by more than lr / 2
(bit-packed; the full generator is 256 MB).

`port` needs that file. On each device it runs the port's K = 1 and K = 3
segments from the golden's seeds (dropout off) and prints, as JSON lines:
  * `golden_deviation` at K = 1 and K = 3 (chip_smoke.py phase 8a's bars);
  * the BN running-statistics arrays that deviate most from the golden at
    K = 3, each with its worst element;
  * the parameter elements whose K = 1 update went the other way from
    JAX's (an Adam step moves an element by about lr whatever its
    gradient's size, so this shows up as a difference of about 2 lr), by
    parameter, with the port's window-1 gradient there;
and the same comparison between the devices. The full result goes to
`build/train_golden_drift/port.json` (or `--out`).

`disc` asks whose float32 arithmetic those opposite steps come from. It
takes window 1's discriminator loss alone at full width (the fake and the
real pass of the LSGAN loss on the golden's GAN rows, the generator's
pseudo-thetas as the fake motion), computes its parameter gradient on the
CPU in JAX float32 (jitted, as the segment is), in the port's float32 and
in the port's float64, and prints each float32 gradient's error against
float64 and the elements whose first Adam step (with the discriminator's
L2 decay) it would take the other way from float64's; the full result
goes to `build/train_golden_drift/disc.json` (or `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

import make_torch_train_golden as tg  # noqa: E402

DUMP = os.path.join(REPO, "build", "train_golden_drift", "jax.npz")
TOP = 8


def jax_dump(path: str = DUMP) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    spec = tg.FULL_SPEC
    res = tg.jax_segments(spec)
    golden = tg.golden_from(spec, res)
    committed = tg.load_golden()
    for k, v in golden.items():
        if k != "spec":
            np.testing.assert_array_equal(v, committed[k], err_msg=k)
    print("the JAX rerun reproduces the committed golden on every key")
    start = tg.port_setup(spec, "cpu")["gen"]
    out = {}
    for name, p in start.named_parameters():
        d = (res[1]["gen"][name.replace(".", "/")]
             - p.detach().numpy()).ravel()
        out[f"gen_up/{name}"] = np.packbits(d > 0)
        out[f"gen_big/{name}"] = np.packbits(
            np.abs(d) > 0.5 * spec["gen_lr"])
    for K in spec["windows"]:
        for group in ("disc", "disc_state"):
            for k, v in res[K][group].items():
                out[f"K{K}/{group}/{k.replace('/', '.')}"] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


def _numpy(named) -> dict:
    return {n: t.detach().cpu().numpy().copy() for n, t in named}


def port_run(device: str, golden: dict) -> dict:
    """K = 1 and K = 3 port segments on `device`: parameters before and
    after K = 1, window 1's gradients, the deviations, the K = 3 BN
    state."""
    spec = golden["spec"]
    res = {}
    setup = tg.port_setup(spec, device)
    res["before"] = {g: _numpy(setup[g].named_parameters())
                     for g in ("gen", "disc")}
    t0 = time.perf_counter()
    out1 = tg.port_segment(setup, 1)
    res["seconds_K1"] = time.perf_counter() - t0
    res["after1"] = {g: _numpy(setup[g].named_parameters())
                     for g in ("gen", "disc")}
    res["grad1"] = {g: _numpy((n, p.grad) for n, p in
                              setup[g].named_parameters())
                    for g in ("gen", "disc")}
    res["dev1"] = tg.golden_deviation(golden, out1, 1)
    del setup
    setup = tg.port_setup(spec, device)
    out3 = tg.port_segment(setup, 3)
    res["dev3"] = tg.golden_deviation(golden, out3, 3)
    res["bn3"] = {k.replace("/", "."): v
                  for k, v in out3["disc_state"].items()
                  if k.endswith(("running_mean", "running_var"))}
    res["adam_steps3"] = out3["adam_steps"]
    return res


def bn_top(got: dict, want: dict) -> list:
    """The BN arrays by largest deviation relative to the array's largest
    magnitude, each with its worst element."""
    rows = []
    for k, w in want.items():
        d = np.abs(got[k] - w)
        i = int(d.argmax())
        rows.append({"array": k, "rel": float(d.max() / max(
            np.abs(w).max(), 1e-12)), "element": i, "abs": float(d[i]),
            "got": float(got[k][i]), "want": float(w[i]),
            "array_max_abs": float(np.abs(w).max())})
    return sorted(rows, key=lambda r: -r["rel"])[:TOP]


def directions(before: dict, after: dict, lr: float) -> dict:
    """Per parameter, (moved up, moved by more than lr / 2) per element."""
    out = {}
    for name, p0 in before.items():
        d = (after[name] - p0).ravel()
        out[name] = (d > 0, np.abs(d) > 0.5 * lr)
    return out


def jax_directions(jax: dict, run: dict, group: str, lr: float) -> dict:
    """JAX's K = 1 update directions, from the dump."""
    before = run["before"][group]
    if group == "disc":
        return directions(before, {n: jax[f"K1/disc/{n}"] for n in before},
                          lr)
    return {n: tuple(np.unpackbits(jax[f"{key}/{n}"])[:p.size].astype(bool)
                     for key in ("gen_up", "gen_big"))
            for n, p in before.items()}


def opposite_updates(run: dict, other: dict, lr: float, group: str) -> dict:
    """Per parameter of `group`, the elements whose K = 1 update in `run`
    and in `other` (`directions`) point opposite ways while one of them
    moved by more than lr / 2; a few examples with the gradient in
    `run`."""
    per_param, examples = {}, []
    mine = directions(run["before"][group], run["after1"][group], lr)
    for name, (up, big) in mine.items():
        other_up, other_big = other[name]
        flip = (big | other_big) & (up != other_up)
        if not flip.any():
            continue
        g = run["grad1"][group][name].ravel()
        p0 = run["before"][group][name].ravel()
        d = run["after1"][group][name].ravel() - p0
        per_param[name] = {"count": int(flip.sum()), "of": int(g.size),
                           "grad_abs_median": float(np.median(np.abs(g))),
                           "grad_abs_at_flips_max": float(
                               np.abs(g[flip]).max())}
        for i in np.flatnonzero(flip)[:3]:
            examples.append({"param": name, "element": int(i),
                             "update_over_lr": float(d[i] / lr),
                             "grad": float(g[i]),
                             "param_before": float(p0[i])})
    return {"per_param": per_param, "examples": examples[:TOP]}


def port_report(devices, out_path: str) -> None:
    golden = tg.load_golden()
    spec = golden["spec"]
    lrs = {"gen": spec["gen_lr"], "disc": spec["disc_lr"]}
    with np.load(DUMP) as z:
        jax = {k: z[k] for k in z.files}
    bn_jax = {k[len("K3/disc_state/"):]: v for k, v in jax.items()
              if k.startswith("K3/disc_state/")
              and k.endswith(("running_mean", "running_var"))}
    runs, report = {}, {"card": None, "spec": spec}
    if torch.cuda.is_available():
        report["card"] = torch.cuda.get_device_name(0)
    for device in devices:
        run = runs[device] = port_run(device, golden)
        row = {"device": device, "seconds_K1": run["seconds_K1"],
               "dev1": run["dev1"], "dev3": run["dev3"],
               "adam_steps3": run["adam_steps3"],
               "bn_top_vs_jax": bn_top(run["bn3"], bn_jax)}
        for g, lr in lrs.items():
            row[f"opposite_vs_jax_{g}"] = opposite_updates(
                run, jax_directions(jax, run, g, lr), lr, g)
        report[device] = row
        print(json.dumps({"device": device, "dev1": row["dev1"],
                          "dev3": row["dev3"],
                          "bn_top_vs_jax": row["bn_top_vs_jax"][:3],
                          "opposite_vs_jax": {
                              g: row[f"opposite_vs_jax_{g}"]["per_param"]
                              for g in lrs}}), flush=True)
    if len(devices) == 2:
        a, b = (runs[d] for d in devices)
        cross = {"pair": list(devices),
                 "bn_top": bn_top(b["bn3"], a["bn3"])}
        for g, lr in lrs.items():
            cross[f"opposite_{g}"] = opposite_updates(
                b, directions(a["before"][g], a["after1"][g], lr), lr, g)
        report["cross"] = cross
        print(json.dumps({"cross": {k: (v["per_param"] if isinstance(
            v, dict) and "per_param" in v else v) for k, v in cross.items()}
            | {"bn_top": cross["bn_top"][:3]}}), flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}")


def disc_precision(out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models import gcn as JG
    from tepose_tpu.train import loss as JL
    from tepose_tpu_torch.models.gcn import MotionDiscriminator
    from tepose_tpu_torch.train.loss import adv_disc_l2_loss
    from tepose_tpu_torch.weights import (
        disc_jax_trees_from_state_dict, flatten_tree)

    jax.config.update("jax_platforms", "cpu")
    spec = tg.FULL_SPEC
    S, n_2d = spec["seqlen"], spec["n_2d"]
    data = tg.make_batch(spec)
    b2, b3 = data["batch_2d"], data["batch_3d"]
    fake = np.concatenate([b2["theta_pseu"][:, 0, :S],
                           b3["theta_pseu"][:, :S]])[..., 3:75]
    real = data["amass"][0][..., 3:75]
    mask = np.concatenate([np.ones(n_2d, bool),
                           b3["w_smpl"][:, S - 1] == 0])
    scales = dict(num_gcn_scales=spec["num_gcn_scales"],
                  num_g3d_scales=spec["num_g3d_scales"])

    def port(dtype):
        disc = MotionDiscriminator(
            generator=torch.Generator().manual_seed(spec["disc_seed"]),
            device="cpu", **scales).to(dtype).train()
        m = torch.from_numpy(mask)
        f, r = (disc(torch.from_numpy(x).to(dtype), m) for x in (fake, real))
        adv_disc_l2_loss(r, f, m, m)[2].backward()
        return disc, {n: p.grad.double().numpy()
                      for n, p in disc.named_parameters()}

    disc32, g32 = port(torch.float32)
    _, g64 = port(torch.float64)
    params = {n: p.detach().double().numpy()
              for n, p in disc32.named_parameters()}
    jp, js = disc_jax_trees_from_state_dict(disc32.state_dict())

    def jloss(prm):
        m = jnp.asarray(mask)
        f, r = (JG.motion_discriminator_apply(
            prm, js, jnp.asarray(x), train=True, row_mask=m, **scales)[0]
            for x in (fake, real))
        return JL.adv_disc_l2_loss(r, f, m, m)[2]

    with jax.default_matmul_precision("float32"):
        gj = jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray, jp))
    gjax = {k.replace("/", "."): np.asarray(v, np.float64)
            for k, v in flatten_tree(jax.device_get(gj)).items()}

    wd, eps = spec["disc_wd"], 1e-8
    report = {"spec": spec, "rows": int(mask.sum())}
    for name, g in (("jax_f32", gjax), ("port_f32", g32)):
        err = np.concatenate([(g[k] - g64[k]).ravel() for k in g64])
        truth = np.concatenate([g64[k].ravel() for k in g64])
        flips, examples = {}, []
        for k in g64:
            e32 = (g[k] + wd * params[k]).ravel()
            e64 = (g64[k] + wd * params[k]).ravel()
            opp = (np.sign(e32) != np.sign(e64)) & (
                np.maximum(np.abs(e32), np.abs(e64)) > eps)
            if opp.any():
                flips[k] = int(opp.sum())
                for i in np.flatnonzero(opp)[:2]:
                    examples.append({"param": k, "element": int(i),
                                     "g_f32": float(g[k].ravel()[i]),
                                     "g_f64": float(g64[k].ravel()[i]),
                                     "decay_term": float(
                                         wd * params[k].ravel()[i])})
        report[name] = {
            "abs_err_median": float(np.median(np.abs(err))),
            "abs_err_max": float(np.abs(err).max()),
            "rel_err_of_max": float(np.abs(err).max()
                                    / np.abs(truth).max()),
            "opposite_adam_steps": int(sum(flips.values())),
            "of": int(truth.size), "by_param": flips,
            "examples": examples[:TOP]}
        print(json.dumps({name: {k: v for k, v in report[name].items()
                                 if k != "examples"}}), flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("jax", "port", "disc"))
    ap.add_argument("--devices", default="cpu,cuda")
    ap.add_argument("--out", help="the JSON report (default: "
                    "build/train_golden_drift/<step>.json)")
    args = ap.parse_args()
    if args.step == "jax":
        jax_dump()
        return
    out = args.out or os.path.join(os.path.dirname(DUMP),
                                   f"{args.step}.json")
    if args.step == "disc":
        disc_precision(out)
        return
    from tepose_tpu_torch.evaluate import strict_f32

    strict_f32()
    port_report(tuple(args.devices.split(",")), out)


if __name__ == "__main__":
    main()
