"""The port's coverage of the JAX package, by `ast`, importing neither.

Every top-level public `def` and `class` of `tepose_tpu/**/*.py` has
exactly one of:
  * the same name at the top level of the same module of `tepose_tpu_torch/`;
  * an entry in `COUNTERPARTS`, whose target exists in the port (a renamed
    counterpart: an `*_init` / `*_apply` pair that became an `nn.Module`, a
    JAX program builder that became a function run eagerly);
  * an entry in `NOT_PORTED`, with its reason.

The command-line tools are held the same way: each root script with a
`__main__` block and each script under `tools/` that parses options, where
the port did not add it (it names no `tepose_tpu_torch`), has a module of
the port in `CLI_COUNTERPARTS` that takes every option it takes, or an entry
in `NOT_PORTED`.

`NOT_PORTED` is the list "Not ported, by design" of ROADMAP.md §1, entry for
entry. A key names a module (`utils/cache.py`), a top-level name in one
(`utils/flops.py::xla_flops`) or a method (`streaming/live.py::
LiveSession._warm_reset_step`); package paths are relative to `tepose_tpu/`,
the CLIs' to the repository's root.
"""

import ast
import re
from functools import lru_cache
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "tepose_tpu", REPO / "tepose_tpu_torch"


def _pair(init: str, apply: str, target: str) -> dict:
    return {init: target, apply: target}


COUNTERPARTS = {
    "eval/evaluator.py::make_eval_scan": "eval/evaluator.py::eval_rollout",
    "eval/evaluator.py::make_sharded_eval_scan":
        "eval/evaluator.py::make_sharded_eval_rollout",
    **_pair("models/gcn.py::bn_init", "models/gcn.py::bn_apply",
            "models/gcn.py::MaskedBatchNorm"),
    "models/gcn.py::conv1x1_init": "models/gcn.py::_Affine",
    **_pair("models/gcn.py::temporal_conv_init",
            "models/gcn.py::temporal_conv_apply",
            "models/gcn.py::TemporalConv"),
    **_pair("models/gcn.py::mlp_init", "models/gcn.py::mlp_apply",
            "models/gcn.py::MLP"),
    **_pair("models/gcn.py::ms_gcn_init", "models/gcn.py::ms_gcn_apply",
            "models/gcn.py::MSGCN"),
    **_pair("models/gcn.py::st_ms_gcn_init", "models/gcn.py::st_ms_gcn_apply",
            "models/gcn.py::STMSGCN"),
    **_pair("models/gcn.py::ms_g3d_init", "models/gcn.py::ms_g3d_apply",
            "models/gcn.py::MSG3D"),
    **_pair("models/gcn.py::motion_discriminator_init",
            "models/gcn.py::motion_discriminator_apply",
            "models/gcn.py::MotionDiscriminator"),
    **_pair("models/layers.py::linear_init", "models/layers.py::linear",
            "models/layers.py::make_linear"),
    **_pair("models/layers.py::gru_init", "models/layers.py::gru_apply",
            "models/layers.py::make_gru"),
    **_pair("models/regressor.py::regressor_init",
            "models/regressor.py::regressor_apply",
            "models/regressor.py::Regressor"),
    "models/regressor.py::ief_iterations":
        "models/regressor.py::Regressor.ief_iterations",
    **_pair("models/temporal.py::temporal_attention_init",
            "models/temporal.py::temporal_attention_apply",
            "models/temporal.py::TemporalAttention"),
    **_pair("models/temporal.py::temporal_encoder_init",
            "models/temporal.py::temporal_encoder_apply",
            "models/temporal.py::TemporalEncoder"),
    **_pair("models/temporal.py::vibe_encoder_init",
            "models/temporal.py::vibe_encoder_apply",
            "models/temporal.py::VibeEncoder"),
    **_pair("models/tepose.py::tepose_init", "models/tepose.py::tepose_apply",
            "models/tepose.py::TePose"),
    **_pair("models/tepose.py::vibe_init", "models/tepose.py::vibe_apply",
            "models/tepose.py::Vibe"),
    "models/tepose.py::vibe_demo_apply": "models/tepose.py::vibe_demo_forward",
    "ops/lbs_pallas.py::lbs_skinning_pallas":
        "ops/lbs_skinning.py::lbs_skinning",
    "parallel/dp.py::MeshTreePlacer": "parallel/dp.py::RowShard",
    "parallel/dp.py::make_sharded_train_segment":
        "parallel/dp.py::sharded_train_segment",
    "train/checkpoint.py::flatten_tree": "weights.py::flatten_tree",
    "train/checkpoint.py::unflatten_tree": "weights.py::unflatten_tree",
    "train/checkpoint.py::load_checkpoint": "weights.py::load_checkpoint",
    "train/trainer.py::make_train_segment": "train/trainer.py::train_segment",
    "train/validate.py::make_validate_scan":
        "train/validate.py::validate_scan",
}

NOT_PORTED = {
    "utils/packing.py": "flat packing for the remote TPU link",
    "utils/cache.py": "JAX's persistent compile cache",
    "eval/evaluator.py::make_packed_eval_scan":
        "the flat-packed rollout of the remote TPU link",
    "train/trainer.py::make_packed_train_segment":
        "the flat-packed segment of the remote TPU link",
    "streaming/engine.py::StreamingEngine._put_weights":
        "device_put over the remote TPU link",
    "streaming/engine.py::StreamingEngine._put_batch":
        "device_put over the remote TPU link",
    "streaming/live.py::LiveSession._warm_reset_step":
        "warms a JAX compile; the port compiles nothing",
    "native/__init__.py::have_native":
        "the port builds the native library with g++ or raises",
    "native/__init__.py::_render_mesh_numpy":
        "numpy fallback; the port builds with g++ or raises",
    "native/__init__.py::_crop_normalize_numpy":
        "numpy fallback; the port builds with g++ or raises",
    "utils/flops.py::xla_flops":
        "XLA's cost analysis; the port counts with counted_flops",
    "utils/flops.py::TPU_PEAK_BF16":
        "TPU peaks; the port has the H100's (peak_flops_for)",
    "__graft_entry__.py":
        "JAX's jit check and mesh dry run; the port's are "
        "parallel/mp_dryrun.py and chip_smoke.py",
}

CLI_COUNTERPARTS = {
    "train.py": "train/run.py",
    "evaluate.py": "evaluate.py",
    "demo.py": "demo.py",
    "bench.py": "bench.py",
    "tools/bench_notes.py": "bench_notes.py",
    "tools/convert_checkpoint.py": "convert_checkpoint.py",
    "tools/convert_smpl.py": "convert_smpl.py",
    "tools/precision_sweep.py": "precision_sweep.py",
    "tools/tune_eval_batching.py": "tune_eval_batching.py",
    "tools/verify_release.py": "verify_release.py",
    **{f"tools/preprocess/{m}.py": f"preprocess/{m}.py" for m in (
        "amass", "h36m", "insta", "mpii3d", "pennaction", "posetrack",
        "pseudo_theta", "threedpw")},
}

OPTION = re.compile(r"^--[a-z][-a-z_0-9]*$")


@lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _top_level(path: Path) -> dict:
    """Name -> node of every top-level def, class and assigned name."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update((t.id, node) for t in targets
                       if isinstance(t, ast.Name))
    return out


def _exists(root: Path, ref: str) -> bool:
    """`ref` ("mod.py", "mod.py::name" or "mod.py::Class.method") is
    defined under `root`."""
    module, _, name = ref.partition("::")
    path = root / module
    if not path.is_file():
        return False
    if not name:
        return True
    outer, _, method = name.partition(".")
    node = _top_level(path).get(outer)
    if node is None or not method:
        return node is not None
    return isinstance(node, ast.ClassDef) and any(
        isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name == method for n in node.body)


def _public_names():
    """("models/tepose.py", "vibe_apply"), ... for the JAX package."""
    for path in sorted(JAX.rglob("*.py")):
        module = path.relative_to(JAX).as_posix()
        for node in _tree(path).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) \
                    and not node.name.startswith("_"):
                yield module, node.name


def _jax_clis():
    """The JAX package's command-line scripts, repository-relative."""
    scripts = [p for p in REPO.glob("*.py") if any(
        isinstance(n, ast.If) and "__main__" in ast.unparse(n.test)
        for n in _tree(p).body)]
    scripts += [p for p in REPO.glob("tools/**/*.py") if _options(p)]
    return sorted(p.relative_to(REPO).as_posix() for p in scripts
                  if "tepose_tpu_torch" not in p.read_text())


def _options(path: Path) -> set:
    """The "--option" strings a script names (argparse's and sys.argv's)."""
    return {n.value for n in ast.walk(_tree(path))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and OPTION.match(n.value)}


def test_every_jax_public_name_has_a_counterpart():
    missing = []
    for module, name in _public_names():
        key = f"{module}::{name}"
        if key in COUNTERPARTS:
            ok = _exists(PORT, COUNTERPARTS[key])
        else:
            ok = _exists(PORT, key) or key in NOT_PORTED \
                or module in NOT_PORTED
        if not ok:
            missing.append(key)
    assert not missing, f"JAX names without a counterpart: {missing}"


def test_counterparts_and_not_ported_entries_are_exact():
    """Each entry names a JAX definition that has no same-named port
    counterpart (else it is stale), and each `COUNTERPARTS` target exists,
    so a rename in the port fails here too."""
    public = {f"{m}::{n}" for m, n in _public_names()}
    for key, target in COUNTERPARTS.items():
        assert key in public, f"{key}: not a public JAX name"
        assert not _exists(PORT, key), f"{key}: the port has the same name"
        assert key not in NOT_PORTED and key.split("::")[0] not in NOT_PORTED
        assert _exists(PORT, target), f"{key}: target {target} is missing"
    clis = _jax_clis()
    for key in NOT_PORTED:
        if key in clis:
            assert key not in CLI_COUNTERPARTS, key
            continue
        assert _exists(JAX, key), f"{key}: no such JAX definition"
        assert not _exists(PORT, key), f"{key}: the port has it"


def test_every_jax_cli_has_a_port_module_with_its_options():
    clis = _jax_clis()
    assert {"train.py", "evaluate.py", "demo.py", "bench.py",
            "tools/verify_release.py"} <= set(clis), clis
    assert sorted(CLI_COUNTERPARTS) == sorted(
        c for c in clis if c not in NOT_PORTED), clis
    # train.py and evaluate.py read most options through config.parse_args
    pairs = {**CLI_COUNTERPARTS, "tepose_tpu/config.py": "config.py"}
    for cli, module in pairs.items():
        assert (PORT / module).is_file(), f"{cli}: {module} is missing"
        lacking = _options(REPO / cli) - _options(PORT / module)
        assert not lacking, f"{cli}: {module} lacks {sorted(lacking)}"

