"""Every public name of the JAX package has its counterpart in the port.

One `ast` scan of both source trees (neither package is imported): each
public top-level `def` and `class` of a module of `dftk_tpu/` must be
defined, assigned or imported at the top level of the port's module at the
same path under `dftk_tpu_torch/`.  The exceptions are ROADMAP's "Not to
port" list, written out below, and the two Pallas wrappers, whose
functions became the hand-written kernels' wrappers and the compact-cube
placements (each name mapped to its counterpart).  The list of gaps is
empty and stays so.
"""
import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "dftk_tpu", ROOT / "dftk_tpu_torch"

# ROADMAP "Not to port": TPU workarounds
NOT_TO_PORT_MODULES = {"kernels/dft_matmul.py", "ops/phase.py", "ops/eigen/csplit.py",
                       "ops/eigen/lobpcg_csplit.py"}
NOT_TO_PORT_NAMES = {("config.py", "maybe_enable_compile_cache")}
# the Pallas wrappers: name -> (port module, port name)
MAPPED = {
    ("kernels/fused_local.py", "fused_local_apply"): ("kernels/local_apply.py", "local_apply"),
    ("kernels/fused_local.py", "place_compact_sep"): ("ops/pruned.py", "sphere_to_compact"),
    ("kernels/fused_local.py", "scatter_compact_sep"): ("ops/pruned.py", "sphere_to_compact"),
    ("kernels/fused_local.py", "gather_compact_sep"): ("ops/pruned.py", "compact_to_sphere"),
    ("kernels/fused_filter.py", "fused_filter_mid"): ("kernels/local_apply.py", "local_plane"),
    ("kernels/fused_filter.py", "FusedFilterFactors"): ("kernels/local_apply.py", "LocalFactors"),
    ("kernels/fused_filter.py", "dot_z"): ("kernels/local_apply.py", "pruned_axis_dft"),
}


def public_defs(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def top_level_names(path):
    """Names a module binds at its top level: defs, classes, assignments
    and imports."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def gaps():
    missing = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        if rel in NOT_TO_PORT_MODULES:
            continue
        for name in sorted(public_defs(path)):
            if (rel, name) in NOT_TO_PORT_NAMES:
                continue
            port_rel, port_name = MAPPED.get((rel, name), (rel, name))
            port = PORT / port_rel
            if not port.exists() or port_name not in top_level_names(port):
                missing.append(f"{rel}::{name}")
    return missing


def test_no_public_name_is_missing_from_the_port():
    assert gaps() == []


def test_exceptions_are_still_needed():
    """Each exception names a module or a name the JAX package still has,
    and each mapped counterpart exists (a stale entry would hide a gap)."""
    for rel in NOT_TO_PORT_MODULES:
        assert (REF / rel).exists(), rel
    for rel, name in NOT_TO_PORT_NAMES | set(MAPPED):
        assert name in public_defs(REF / rel), (rel, name)
    for port_rel, port_name in MAPPED.values():
        assert port_name in top_level_names(PORT / port_rel), (port_rel, port_name)
