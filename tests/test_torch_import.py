"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source file imports them, and entry points refuse to fall back
to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_and_reference_out(tmp_path):
    """Importing the port loads no JAX and no module of the JAX package;
    nor does a two-rank gloo ``shard_map`` query through
    ``GraphSession(mesh=)``."""
    code = ("import sys, repro_torch, repro_torch.session, "
            "repro_torch.interop, repro_torch.kernels.ops, repro_torch.algos,"
            " repro_torch.stream, repro_torch.partition, "
            "repro_torch.serving, repro_torch.serving.pool, "
            "repro_torch.serving.batcher, repro_torch.core.mesh, "
            "repro_torch.core.autotune, repro_torch.models.layers, "
            "repro_torch.models.moe, repro_torch.models.model, "
            "repro_torch.configs, repro_torch.training.steps, chip_smoke;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); assert not bad, bad")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout

    from test_torch_shard import spawn_ranks, wait_all
    rank_code = (
        "import os, sys, numpy as np, torch.distributed as dist\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "dist.init_process_group('gloo', init_method=os.environ["
        "'DRONE_INIT'], rank=int(os.environ['RANK']), world_size=2)\n"
        "from repro_torch.algos import SSSP\n"
        "from repro_torch.graphgen import ring_graph\n"
        "from repro_torch.session import GraphSession\n"
        "mesh = init_device_mesh('cpu', (2,), mesh_dim_names=('sub',))\n"
        "s = GraphSession.from_graph(ring_graph(64), 2, mesh=mesh, "
        "device='cpu')\n"
        "res, st = s.query(SSSP(), {'source': 0})\n"
        "assert st.supersteps > 1 and st.collectives > 0\n"
        "assert s.pg.collect(res)[32] == 32, s.pg.collect(res)\n"
        "dist.destroy_process_group()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad); assert not bad, bad\n")
    wait_all(spawn_ranks(rank_code, 2, [], tmp_path / "store"), 300,
             ["rank 0", "rank 1"])


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {n}"


def test_entry_points_refuse_missing_gpu(monkeypatch):
    from repro_torch.core import EngineConfig, partition_and_build, run_sim
    from repro_torch.algos import SSSP
    from repro_torch.device import resolve_device
    from repro_torch.graphgen import ring_graph
    from repro_torch.kernels.ops import spmv
    from repro_torch.session import GraphSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = ring_graph(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphSession.from_graph(g, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sim(SSSP(), partition_and_build(g, 2), {"source": 0},
                EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        spmv(g.src, g.dst, g.weights, [[1.0]] * 64, 64)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_paths_raise_not_implemented(tmp_path, monkeypatch):
    """Every path of the JAX package is ported; ``run`` refuses only what
    the reference refuses: ``shard_map`` without a mesh (ValueError) and a
    checkpoint resume under ``shard_map`` (NotImplementedError, a trace-mode
    feature of the simulator)."""
    from repro_torch.algos import SSSP
    from repro_torch.core import EngineConfig, partition_and_build, run
    from repro_torch.graphgen import ring_graph
    from repro_torch.session import GraphSession

    monkeypatch.setenv("DRONE_AUTOTUNE_DIR", str(tmp_path))
    g = ring_graph(64)
    pg = partition_and_build(g, 2)
    shard = EngineConfig(backend="shard_map")
    with pytest.raises(ValueError, match="needs a mesh"):
        run(SSSP(), pg, {"source": 0}, shard, device="cpu")
    with pytest.raises(NotImplementedError, match="trace-mode"):
        run(SSSP(), pg, {"source": 0}, shard, mesh=object(),
            resume_from=str(tmp_path / "bsp_000002.npz"), device="cpu")
    # the rest runs: 'auto', the streaming lifecycle, EBV, rebalance,
    # serving; a session without a mesh serves a shard_map config on the
    # simulator, as the reference's does
    run(SSSP(), pg, {"source": 0}, EngineConfig(edge_backend="auto"),
        device="cpu")
    sess = GraphSession.from_graph(g, 2, "ebv", device="cpu",
                                   rebalance="manual", cfg=shard)
    assert sess.cfg.backend == "sim"
    sess.update(adds=([0], [1]))
    assert sess.flush().n_added == 1 and sess.compact().remap is not None
    sess.query(SSSP(), {"source": 0}, cfg=EngineConfig(edge_backend="auto"))
    sess.rebalance()
    out = sess.query_batch(SSSP(), [{"source": 0}, {"source": 1}])
    assert [st.batch_size for _, st in out] == [2, 2]


def test_serving_loads_no_jax():
    """``repro_torch.serving`` and a ``SessionPool`` / ``MicroBatcher``
    round (a result cache, a batched launch, a fast-path hit) load no
    ``jax`` and no module of the JAX package."""
    code = ("import sys, numpy as np\n"
            "import repro_torch.serving as S\n"
            "from repro_torch.algos import SSSP\n"
            "from repro_torch.graphgen import powerlaw_graph\n"
            "g = powerlaw_graph(300, seed=1, weighted=True).as_undirected()\n"
            "rc = S.ResultCache(store=S.DictStore())\n"
            "pool = S.SessionPool(result_cache=rc, device='cpu')\n"
            "pool.open('a', g, n_parts=3)\n"
            "bat = S.MicroBatcher(pool, S.BatchPolicy(max_batch=2))\n"
            "fs = [bat.submit(SSSP(), {'source': s}, tenant='a')"
            " for s in (0, 1)]\n"
            "assert all(f.result(timeout=60)[1].batch_size == 2 for f in fs)\n"
            "f = bat.submit(SSSP(), {'source': 0}, tenant='a')\n"
            "assert f.done() and bat.stats.fast_path_hits == 1\n"
            "pool.close_all()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_ebv_auto_and_rebalance_load_no_jax(tmp_path):
    """Routing through ``"ebv"`` (whose router spec names its module by
    string), an ``'auto'`` query and a rebalance load no ``jax`` and no
    module of the JAX package."""
    code = ("import sys, numpy as np\n"
            "from repro_torch.algos import SSSP\n"
            "from repro_torch.core import EngineConfig\n"
            "from repro_torch.graphgen import powerlaw_graph\n"
            "from repro_torch.session import GraphSession\n"
            "g = powerlaw_graph(300, seed=1, weighted=True).as_undirected()\n"
            "s = GraphSession.from_graph(g, 3, 'ebv', device='cpu',\n"
            "    rebalance='manual', cfg=EngineConfig(edge_backend='auto'))\n"
            "_, st = s.query(SSSP(), {'source': 0})\n"
            "assert len(st.partition_edge_backends) == 3\n"
            "s.update(deletes=(g.src[:10], g.dst[:10])); s.flush()\n"
            "s.rebalance(target=1.0)\n"
            "assert type(s.ctx.router_state).__module__ == "
            "'repro_torch.partition.ebv'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               DRONE_AUTOTUNE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_algos_export_the_reference_suite():
    """``repro_torch.algos`` exports every name of ``repro.algos``, and
    importing it alone loads no JAX."""
    import repro.algos as RA
    import repro_torch.algos as TA
    assert TA.__all__ == RA.__all__
    assert all(hasattr(TA, n) for n in TA.__all__)
    code = ("import sys, repro_torch.algos; bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_graph_engine_loads_no_lm_stack():
    """The graph engine (``repro_torch.core``, whose BSP checkpoints share
    ``repro_torch.npz_io``'s file format with the LM's) loads nothing of
    the LM stack: no ``repro_torch.training``, ``models`` or ``launch``."""
    code = ("import sys, repro_torch.core.engine, repro_torch.core\n"
            "bad = [m for m in sys.modules if m.split('.')[:2] in "
            "(['repro_torch', 'training'], ['repro_torch', 'models'], "
            "['repro_torch', 'launch'])]\n"
            "assert 'repro_torch.npz_io' in sys.modules\n"
            "print(bad); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_launch_dry_run_tools_load_no_jax(tmp_path):
    """``repro_torch.launch.mesh``, ``dryrun_graph``, ``fake_stats`` and
    ``roofline`` load no ``jax`` and no module of the JAX package, nor
    does running a dry-run cell, the roofline over it and
    ``param_counts``; the cell leaves no process group behind."""
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.fake_stats\n"
            "from repro_torch.launch import dryrun_graph as D, roofline as R\n"
            "rec = D.run_cell('kron26', 'sssp', 'multipod', sys.argv[1])\n"
            "assert rec['status'] == 'ok', rec\n"
            "assert not dist.is_initialized()\n"
            "R.main(['--dry', sys.argv[1], '--out', sys.argv[1] + '/r.md'])\n"
            "R.param_counts('olmo_1b')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_lm_stack_loads_no_jax():
    """``repro_torch.models`` (``ssm`` too), ``repro_torch.configs`` (every
    arch module), ``repro_torch.training`` (every module) and
    ``repro_torch.launch.train`` load no ``jax`` and no module of the JAX
    package, nor does a prefill and a decode step on the CPU of a dense,
    the two MoE, the Jamba, the xLSTM and the encoder-decoder smoke configs
    (seamless with its frame features and its encoded memory), nor two
    training steps with a checkpoint through the training driver."""
    code = ("import sys, tempfile, torch\n"
            "import repro_torch.models, repro_torch.models.model as M\n"
            "import repro_torch.models.moe, repro_torch.models.layers\n"
            "import repro_torch.models.ssm\n"
            "import repro_torch.configs as C, repro_torch.training\n"
            "import repro_torch.training.optimizer, "
            "repro_torch.training.data\n"
            "import repro_torch.training.checkpoint, "
            "repro_torch.launch.train as T\n"
            "from repro_torch.training import steps as S\n"
            "for a in C.ARCHS: C.get_config(a); C.get_smoke_config(a)\n"
            "for a in ('phi4_mini_3p8b', 'phi35_moe_42b', "
            "'deepseek_v3_671b', 'jamba_v01_52b', 'xlstm_350m', "
            "'seamless_m4t_large_v2'):\n"
            "    cfg = C.get_smoke_config(a)\n"
            "    m = M.init_model(cfg, device='cpu')\n"
            "    b = {'tokens': torch.zeros((2, 5), dtype=torch.int32)}\n"
            "    if cfg.frontend:\n"
            "        b['frontend'] = torch.zeros((2, cfg.frontend_len, "
            "cfg.frontend_dim))\n"
            "    nxt, c = S.make_prefill_step(cfg, 8)(m, b)\n"
            "    d = {'tokens': nxt[:, None]}\n"
            "    if cfg.n_enc_layers:\n"
            "        with torch.no_grad(): d['memory'] = M._encode(m, b, "
            "cfg)\n"
            "    nxt, c = S.make_serve_step(cfg)(m, c, d)\n"
            "    assert c[0]['idx'] == 6\n"
            "_, h = T.train('deepseek_v3_671b', steps=2, batch=2, seq=8, "
            "ckpt_dir=tempfile.mkdtemp(), device='cpu')\n"
            "assert len(h) == 2\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


# the reference's parameter count (jax.eval_shape of its init_model) of the
# configs ported in item 5e / 5f, by dtype
_PORTED_PARAMS = {"xlstm_350m": {"float32": 187_013_120},
                  "seamless_m4t_large_v2": {"float32": 1_633_304_576},
                  "internvl2_26b": {"bfloat16": 19_880_921_088}}


@pytest.mark.parametrize("arch,item", [
    ("deepseek_v3_671b", None), ("phi35_moe_42b", None),
    ("jamba_v01_52b", None), ("xlstm_350m", "5e"), ("internvl2_26b", "5f"),
    ("seamless_m4t_large_v2", "5f")])
def test_unported_lm_archs_raise_not_implemented(arch, item):
    """Each of these archs was once refused, naming the ROADMAP item that
    would port it; all are ported now (MoE 5b, MLA + MTP 5c, Mamba and
    Jamba 5d; ``item``: xLSTM 5e, the VLM and the encoder-decoder 5f), and
    the LM stack has no refusal left (``not_ported`` is gone). Each full
    config builds on the
    meta device with the reference's parameter count per dtype
    (``jax.eval_shape`` of its ``init_model``: Jamba's float32 ``A_log``
    and ``D``, xLSTM's float32 ``wi`` / ``wf`` / ``b`` among them), and its
    smoke config serves a prefill and a decode step (with its frontend
    features, and the encoder-decoder with its memory)."""
    import collections
    import math

    import jax
    import repro.configs as RC
    import repro.models.model as RM
    import repro_torch.models.layers as TL
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import Model, _encode, init_model
    from repro_torch.training import steps as S
    assert not hasattr(TL, "not_ported")
    ref = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0),
                                               RC.get_config(arch)))
    want, got = collections.Counter(), collections.Counter()
    for leaf in jax.tree.leaves(ref):
        want[str(leaf.dtype)] += math.prod(leaf.shape)
    for p in Model(get_config(arch), device="meta").parameters():
        got[str(p.dtype).removeprefix("torch.")] += p.numel()
    assert got == want
    if item is None:
        assert want["bfloat16"] > 4e10
    else:
        assert dict(want) == _PORTED_PARAMS[arch]
    cfg = get_smoke_config(arch)
    model = init_model(cfg, device="cpu")
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.int32)}
    off = 0
    if cfg.frontend:
        batch["frontend"] = torch.zeros((2, cfg.frontend_len,
                                         cfg.frontend_dim))
        off = 0 if cfg.n_enc_layers else cfg.frontend_len
    nxt, caches = S.make_prefill_step(cfg, 8 + off)(model, batch)
    step = {"tokens": nxt[:, None]}
    if cfg.n_enc_layers:
        with torch.no_grad():
            step["memory"] = _encode(model, batch, cfg)
    nxt, caches = S.make_serve_step(cfg)(model, caches, step)
    assert nxt.shape == (2,) and caches[0]["idx"] == 6 + off


def test_lm_entry_points_refuse_missing_gpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import model_params_from_numpy
    from repro_torch.models.model import Model, init_cache, init_model

    cfg = get_smoke_config("olmo_1b")
    tree = {n: p.detach().numpy() for n, p in
            init_model(cfg, device="cpu").named_parameters()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_model(cfg), lambda: Model(cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: model_params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert init_cache(cfg, 1, 8, device="cpu")[0]["k"].device.type == "cpu"
