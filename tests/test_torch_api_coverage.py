"""Every public name of the JAX package has its counterpart in the port.

Each module of `deepfilternet_tpu/` and its counterpart in
`deepfilternet_torch/` are parsed with `ast` (neither package is imported).
A module's public names are its top-level functions, classes and assigned
names (constants) that do not start with "_", and, in an `__init__.py`,
the names it imports (its re-exports); a public class's are its public
methods and properties. Each must be defined in the port's module, under
the port's own name where the port renames it (`RENAMES`), unless
`EXCLUDED` lists it with the reason it is left out. The repository's root
`scripts/` map to port scripts the same way (`ROOT_SCRIPTS`).
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "deepfilternet_tpu", "deepfilternet_torch"

# JAX module -> the port's module, where the port names the file otherwise
MODULES = {
    "ops/pallas_frontend.py": "ops/fused_frontend.py",
    "ops/pallas_cell.py": "ops/whole_cell.py",
    "streaming_pallas.py": "streaming_whole_cell.py",
}
# (JAX module, name) -> (the port's module, its name)
RENAMES = {
    ("streaming_pallas.py", "PallasStreamingRuntime"):
        ("streaming_whole_cell.py", "WholeCellStreamingRuntime"),
    ("ops/pallas_cell.py", "cell_process_xla"): ("ops/whole_cell.py", "cell_process_plain"),
    # JAX's ops/__init__ re-exports the function `stft` over the module of
    # that name; the port keeps `deepfilternet_torch.ops.stft` the module
    ("ops/__init__.py", "stft"): ("ops/stft.py", "stft"),
}
_XLA_FUSION = ("regroups the same math for XLA on a TPU and changes no result; the port's "
               "eager path and its CUDA kernels do not need it")
# JAX module -> {name: reason}; "*" leaves out the whole module, "=" every
# assigned name of it
EXCLUDED = {
    "utils/platform.py": {"*": "re-asserts JAX_PLATFORMS for JAX's backends"},
    "ops/pallas_cell.py": {
        "make_cell_kernel": "builds the Pallas kernel; the port's whole-cell kernel is CUDA C++ "
                            "(csrc/whole_cell.cu, csrc/whole_cell_rows.cu, built by kernels.py)"},
    "models/dfnet3.py": {"merge_emb_heads": _XLA_FUSION, "merge_dec_df_gru0": _XLA_FUSION},
    "nn/layers.py": {name: _XLA_FUSION for name in (
        "fold_conv_layer", "fold_conv_tree", "fuse_gru_layer", "fuse_gru_tree",
        "gru_cell_from_gates")},
    "nn/__init__.py": {name: _XLA_FUSION for name in (
        "fold_conv_layer", "fold_conv_tree", "fuse_gru_layer", "fuse_gru_tree")},
    "parallel/mesh.py": {"batch_sharding": "builds a JAX NamedSharding, which means nothing in "
                                           "torch",
                         "replicated": "builds a JAX NamedSharding, which means nothing in torch"},
    "scripts/export.py": {"export_stablehlo": "StableHLO is JAX's format; the port exports "
                                              "with torch.export"},
    "train/trainer.py": {"scale_by_amsgrad_torch": "reproduces torch.optim's amsgrad in optax; "
                                                   "the port uses torch.optim directly"},
    "utils/seed.py": {"jax_key": "a JAX PRNG key; the port has torch_generator"},
    "scripts/overfit_trial.py": {
        "=": "JAX's trial runs at import, through module globals; the port's runs from main()",
        "infer": "a jitted forward of JAX's import-time trial; the port's main() runs it inline"},
}
# the repository's root scripts -> the port's script, or the reason there is none
ROOT_SCRIPTS = {
    "make_vtlp_pool.py": "scripts/make_vtlp_pool.py",
    "tpu_train.sh": "scripts/cuda_train.sh",
    **{f"bench_{n}.py": "the TPU benchmark; the card's benchmark waits for its own cell"
       for n in ("ablate", "chunked", "configs", "data", "dispatch", "serve", "unroll")},
    "head_to_head.py": "needs the reference's torch repository, which is not in this one",
    "calibrate_pesq.py": "needs the reference's assets, which are not in this repository",
}


def public_names(path):
    """(module-level public names, {public class: its public methods and
    properties}, the assigned ones among the module-level names)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top, assigned, members = set(), set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            top.add(node.name)
            if isinstance(node, ast.ClassDef):
                members[node.name] = {
                    b.name for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not b.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and not n.id.startswith("_"):
                        assigned.add(n.id)
        elif isinstance(node, ast.ImportFrom) and path.endswith("__init__.py"):
            top.update(a.asname or a.name for a in node.names
                       if not (a.asname or a.name).startswith("_"))
    return top | assigned, members, assigned


def _jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".py"))


def test_every_jax_module_is_covered():
    """The module list below is the JAX package's, and every exclusion names
    a module and a name that exist there."""
    modules = _jax_modules()
    assert len(modules) > 50
    for module, names in EXCLUDED.items():
        assert module in modules, module
        if "*" in names:
            continue
        top, _, _ = public_names(os.path.join(REPO, JAX_PKG, module))
        assert set(names) - {"="} <= top, (module, set(names) - top)
    for module, _ in RENAMES:
        assert module in modules, module


@pytest.mark.parametrize("module", _jax_modules())
def test_port_has_every_public_name(module):
    excluded = EXCLUDED.get(module, {})
    if "*" in excluded:
        assert not os.path.exists(os.path.join(REPO, PORT_PKG, module)), module
        return
    top, members, assigned = public_names(os.path.join(REPO, JAX_PKG, module))
    port_module = MODULES.get(module, module)
    assert os.path.isfile(os.path.join(REPO, PORT_PKG, port_module)), port_module
    missing = []
    for name in sorted(top):
        if name in excluded or ("=" in excluded and name in assigned):
            continue
        where, port_name = RENAMES.get((module, name), (port_module, name))
        port_top, port_members, _ = public_names(os.path.join(REPO, PORT_PKG, where))
        if port_name not in port_top:
            missing.append(f"{name} (as {where}::{port_name})")
        else:
            missing += [f"{name}.{m}" for m in sorted(
                members.get(name, set()) - port_members.get(port_name, set()))]
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("script", sorted(ROOT_SCRIPTS))
def test_root_script_has_its_port(script):
    assert os.path.isfile(os.path.join(REPO, "scripts", script)), script
    target = ROOT_SCRIPTS[script]
    if not target.startswith("scripts/"):
        return  # left out, for the reason given
    path = os.path.join(REPO, PORT_PKG, target)
    assert os.path.isfile(path), target
    if script.endswith(".sh"):
        assert os.stat(path).st_mode & 0o111, f"{target} is not executable"
        with open(path) as f:
            assert "python3 -m deepfilternet_torch.train.run" in f.read()
    else:
        top, _, _ = public_names(os.path.join(REPO, "scripts", script))
        assert top <= public_names(path)[0], (script, top)


def test_root_scripts_are_all_listed():
    scripts = os.listdir(os.path.join(REPO, "scripts"))
    assert set(ROOT_SCRIPTS) == {f for f in scripts if f.endswith((".py", ".sh"))}


# the card check and the A/B tools beside the kernels: the tools import the
# check for its inputs and checks, never the other way round, and the package
# imports neither
CHECK, TOOLS = "chip_smoke.py", os.path.join(PORT_PKG, "csrc", "tools")


def _imports(path):
    """Every module an import statement anywhere in the file names, and the
    names it binds `chip_smoke` to."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    modules, check = set(), set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            modules.update(a.name for a in n.names)
            check.update(a.asname or a.name for a in n.names if a.name == CHECK[:-3])
        elif isinstance(n, ast.ImportFrom) and n.module:
            modules.add(n.module)
    return tree, modules, check


def _tool_files():
    root = os.path.join(REPO, TOOLS)
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".py"))


@pytest.mark.parametrize("arrow", ["the check imports no tool", "the package imports no check",
                                   "the tools use names the check defines"])
def test_imports_point_from_the_tools_to_the_check(arrow):
    if arrow == "the check imports no tool":
        tools = {os.path.basename(p)[:-3] for p in _tool_files()}
        _, modules, _ = _imports(os.path.join(REPO, CHECK))
        bad = [m for m in modules if m.split(".")[0] in tools or "csrc" in m.split(".")]
        assert tools and not bad, bad
    elif arrow == "the package imports no check":
        root = os.path.join(REPO, PORT_PKG)
        paths = [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
                 if f.endswith(".py") and not d.startswith(os.path.join(REPO, TOOLS))]
        bad = [p for p in paths if any(m.split(".")[0] == CHECK[:-3] for m in _imports(p)[1])]
        assert len(paths) > 50 and not bad, bad
    else:
        defined, _, _ = public_names(os.path.join(REPO, CHECK))
        used = {}
        for path in _tool_files():
            tree, _, aliases = _imports(path)
            used[os.path.basename(path)] = {
                n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id in aliases}
        missing = {tool: names - defined for tool, names in used.items() if names - defined}
        assert sum(map(len, used.values())) > 10 and not missing, missing
