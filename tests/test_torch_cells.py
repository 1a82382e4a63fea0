"""The port's dry-run cells against the reference's (``repro.launch.cells``):
the cell list, every cell's model FLOPs bit for bit, and on the
reference's sample cells (``tests/test_cells.py``) the fake arguments at
full published width, leaf for leaf.

The reference's side is built on a (1, 1) mesh
(``repro.distributed.sharding.make_mesh``): one card, as the port's cells
are.  Nothing here allocates a full-width tensor: the port's cells are
built inside a ``FakeTensorMode``, the reference's are abstract.
"""
import dataclasses
import math

import numpy as np
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.configs import iter_cells as jiter_cells
from repro.distributed.sharding import make_mesh
from repro.launch import cells as jcells

from repro_torch.configs import get_config, iter_cells
from repro_torch.launch import cells

SAMPLE = [
    ("llama3.2-3b", "train_4k"),
    ("llama3.2-3b", "decode_32k"),
    ("granite-moe-1b-a400m", "prefill_32k"),
    ("sasrec", "train_batch"),
    ("autoint", "serve_p99"),
    ("dcn-v2", "retrieval_cand"),
    ("bst", "serve_bulk"),
    ("graphsage-reddit", "full_graph_sm"),
    ("graphsage-reddit", "molecule"),
]


@pytest.fixture(scope="module")
def mesh11():
    return make_mesh((1, 1), ("data", "model"))


def _leaves(tree, prefix=""):
    """{dotted path: (shape, dtype name)} of a nest of dicts, lists,
    tuples and dataclasses whose leaves are tensors or ShapeDtypeStructs."""
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _bytes(leaves):
    return sum(math.prod(s) * np.dtype(d).itemsize
               for s, d in leaves.values())


def test_iter_cells_is_the_reference_list():
    assert iter_cells() == jiter_cells()
    assert len(iter_cells()) == 40
    assert sum(1 for *_, skip in iter_cells() if skip) == 5


def test_model_flops_equal_the_reference_for_every_cell(mesh11):
    """The 40 cells and the 8 RMC1 / RMC4 cells, bit for bit.  The five
    skipped long_500k cells are not built by either side: their LM
    estimate is compared directly."""
    n = 0
    for arch, shape, skip in iter_cells() + cells.dlrm_cells():
        if skip:
            cfg, jcfg = get_config(arch), jget_config(arch)
            sh, jsh = cfg.shapes()[shape], jcfg.shapes()[shape]
            got = cells.lm_model_flops(cfg, sh.global_batch, "serve",
                                       seq=sh.seq_len)
            want = jcells.lm_model_flops(jcfg, jsh.global_batch, "serve",
                                         seq=jsh.seq_len)
        else:
            with FakeTensorMode():
                got = cells.build_cell(arch, shape, "cpu").model_flops
            want = jcells.build_cell(arch, shape, mesh11).model_flops
        assert got == want, (arch, shape, got, want)
        n += 1
    assert n == 48


@pytest.mark.parametrize("arch,shape", SAMPLE)
def test_fake_arguments_match_the_reference(arch, shape, mesh11):
    """Parameters and batches leaf for leaf (dotted path, shape, dtype);
    optimizer state, engine state and the KV cache by total bytes."""
    with FakeTensorMode():
        cell = cells.build_cell(arch, shape, "cpu")
    jcell = jcells.build_cell(arch, shape, mesh11)
    args, jargs = cell.args, jcell.abstract_args
    assert len(args) == len(jargs)
    # the parameters: first argument of every cell
    assert _leaves(args[0]) == _leaves(jargs[0])
    # the batch: last argument, except decode (params, cache, tokens, pos)
    kind = get_config(arch).shapes()[shape].kind
    if kind == "decode":
        assert _leaves(args[2]) == _leaves(jargs[2])        # tokens
        # pos: the reference's traced int32 scalar, the port's host int
        assert jargs[3].shape == () and isinstance(args[3], int)
        assert _bytes(_leaves(args[1])) == _bytes(_leaves(jargs[1]))
        return
    assert _leaves(args[-1]) == _leaves(jargs[-1])
    # the states in between (optimizer, engine, embedding optimizer): the
    # same bytes; both keep adam's step as an int32 scalar and the same
    # factored adafactor moments, the same engine tiers and page tables
    for a, j in zip(args[1:-1], jargs[1:-1]):
        assert _bytes(_leaves(a)) == _bytes(_leaves(j)), (arch, shape)
