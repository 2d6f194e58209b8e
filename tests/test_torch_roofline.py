"""The port's dry-run cost model (``repro_torch.roofline``): the record of
a traced step's aten ops on rank 0's local shards, against programs of
known exact cost, the kernels' meta ops against ``FlopCounterMode`` over
their plain versions, and the reference's pure-Python parts
(``active_param_count``, ``model_flops_estimate``, ``render_table``)
equal to the reference's.  The counterparts of ``tests/test_roofline.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.roofline.trace import OpTrace, analyze, trace  # noqa: E402

META = dict(device="meta")


def _totals(fn, *args):
    return analyze(trace(fn, *args)[1])


# ------------------------------------------------------------ counted exactly

def test_single_matmul_flops_exact():
    a = torch.empty(256, 512, **META)
    b = torch.empty(512, 128, **META)
    t = _totals(lambda x, y: x @ y, a, b)
    assert t.flops == 2 * 256 * 512 * 128
    assert t.flops_by_dtype == {"float32": 2 * 256 * 512 * 128}


def test_loop_flops_multiplied_by_trip_count():
    """A 13-step loop counts 13 times: the record keeps each op's count."""
    def loop(h, ws):
        for w in ws.unbind(0):
            h = torch.tanh(h @ w)
        return h

    t = _totals(loop, torch.empty(64, 64, **META), torch.empty(13, 64, 64, **META))
    assert t.flops == 13 * 2 * 64**3
    assert not t.notes


def test_nested_loop_flops():
    def nested(h, ws):
        for outer in ws.unbind(0):
            for w in outer.unbind(0):
                h = torch.tanh(h @ w)
        return h

    t = _totals(nested, torch.empty(32, 32, **META), torch.empty(3, 5, 32, 32, **META))
    assert t.flops == 15 * 2 * 32**3


def test_grad_flops_counts_fwd_and_bwd():
    def grads(w, x):
        w, x = w.requires_grad_(True), x.requires_grad_(True)
        loss = torch.sum((x @ w) ** 2)
        return torch.autograd.grad(loss, (w, x))

    x = torch.empty(128, 128, **META)
    t = _totals(grads, x.clone(), x.clone())
    assert t.flops == 3 * 2 * 128**3  # fwd + dW + dX


def test_bf16_product_counted_in_its_dtype():
    a = torch.empty(64, 32, dtype=torch.bfloat16, **META)
    t = _totals(lambda x: x @ x.T, a)
    assert t.flops_by_dtype == {"bfloat16": 2 * 64 * 64 * 32}


def test_bytes_scale_with_tensor_size():
    f = lambda x: torch.tanh(x) * 2.0 + 1.0  # noqa: E731
    t1 = _totals(f, torch.empty(128, 128, **META))
    t2 = _totals(f, torch.empty(512, 512, **META))
    assert t2.bytes > 10 * t1.bytes  # 16x elements
    # three elementwise ops, each reading and writing the tensor once
    assert t1.bytes == 3 * 2 * 128 * 128 * 4


def test_views_are_free():
    def views(x):
        return x.view(64, 32).reshape(2, 1024)[1].unsqueeze(0).expand(4, 1024).transpose(0, 1)

    t = _totals(views, torch.empty(32, 64, **META))
    assert t.bytes == 0 and t.flops == 0
    # a reshape that must copy is not a view: the copy's read and write
    t = _totals(lambda x: x.transpose(0, 1).reshape(2, 1024), torch.empty(32, 64, **META))
    assert t.bytes == 2 * 32 * 64 * 4


def test_slice_update_counts_the_slice():
    """An in-place write of a slice reads and writes the update, never the
    buffer, as the reference counts ``dynamic-update-slice``."""
    buf = torch.empty(1024, 256, **META)
    row = torch.empty(2, 256, **META)
    assert _totals(lambda b, r: b[4:6].copy_(r), buf, row).bytes == 2 * 2 * 256 * 4
    idx = torch.empty(2, dtype=torch.int64, **META)
    t = _totals(lambda b, i, r: b.index_copy_(0, i, r), buf, idx, row)
    assert t.bytes == 2 * (2 * 256 * 4 + 2 * 8)
    t = _totals(lambda b, i, r: b.index_put_((i,), r), buf, idx, row)
    assert t.bytes == 2 * (2 * 256 * 4 + 2 * 8)


def test_record_is_json_and_reanalyzes_alike():
    _, record = trace(lambda x, y: torch.relu(x @ y).sum(), torch.empty(8, 4, **META),
                      torch.empty(4, 3, **META))
    again = json.loads(json.dumps(record))
    assert analyze(again) == analyze(record)
    assert sum(e["n"] for e in record) == 3


def test_collective_payload_of_an_all_reduce():
    """A partial sum made whole on a fake 4-rank mesh lowers to an
    all_reduce; its payload is at least the local shard's bytes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch.dryrun import fake_world

    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
        part = DTensor.from_local(torch.empty(16, 128, **META), mesh, (Partial(),))
        t = _totals(lambda p: p.redistribute(mesh, (Replicate(),)), part)
    assert not dist.is_initialized()
    assert t.coll_bytes >= 16 * 128 * 4
    assert "all-reduce" in t.coll_by_op and t.coll_count["all-reduce"] == 1


def test_dtensor_product_counted_on_the_local_shards():
    """FlopCounterMode over DTensors counts global shapes; the trace counts
    rank 0's local product: (1024 x 2048) @ (2048 x 352) of a (16384 x
    2048) @ (2048 x 5632) placed rows over data, columns over model."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import fake_world

    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        a = distribute_tensor(torch.empty(16384, 2048, **META), mesh, (Shard(0), Replicate()))
        b = distribute_tensor(torch.empty(2048, 5632, **META), mesh, (Replicate(), Shard(1)))
        t = _totals(lambda x, y: x @ y, a, b)
    assert t.flops == 2 * 1024 * 2048 * 352
    assert t.coll_bytes == 0


# ------------------------------------------------------------ the kernels' meta ops

def _flop_counter(fn, *args) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _kernel_cases():
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.lstm_cell import lstm_cell_plain
    from repro_torch.kernels.lstm_seq import lstm_seq_plain
    from repro_torch.kernels.lstm_stack import lstm_stack_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    def r(*shape, dtype=torch.float32):
        return lambda dev: torch.zeros(shape, dtype=dtype, device=dev)

    b, i, h, t, heads, hd, s = 6, 5, 7, 3, 2, 4, 9
    cell = (r(b, i), r(b, h), r(b, h), r(4, i, h), r(4, h, h), r(4, h))
    seq = (r(t, b, i), r(b, h), r(b, h), r(4, i, h), r(4, h, h), r(4, h))
    wkv = (r(b, t, heads, hd, dtype=torch.bfloat16),) * 3 + (r(b, t, heads, hd), r(heads, hd),
                                                             r(b, heads, hd, hd))
    attn = (r(b, heads, s, hd),) * 3
    h2 = 3      # a stack of two layers, i -> h -> h2
    stack = (r(t, b, i), r(i, 4 * h), r(h, 4 * h), r(4 * h), r(h, 4 * h2), r(h2, 4 * h2),
             r(4 * h2))

    def layers(w):
        return [dict(zip(("wx", "wh", "b"), w[k:k + 3])) for k in range(0, len(w), 3)]

    return {
        "lstm_cell": (cell, lstm_cell_plain, lambda *a: ops.lstm_cell_op(a[3:], *a[:3]),
                      8 * b * h * (i + h)),
        "lstm_seq": (seq, lstm_seq_plain, lambda *a: ops.lstm_seq_op(a[3:], *a[:1], *a[1:3]),
                     8 * t * b * h * (i + h)),
        "lstm_stack": (stack, lambda xs, *w: lstm_stack_plain(xs, layers(w)),
                       lambda xs, *w: ops.lstm_stack_op(layers(w), xs),
                       8 * t * b * (h * (i + h) + h2 * (h + h2))),
        "wkv6": (wkv, wkv6_plain, ops.wkv6_op, 2 * b * t * heads * hd * hd),
        "flash_attention": (attn, flash_attention_plain,
                            lambda q, k, v: ops.flash_attention_op(
                                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                            4 * b * heads * s * s * hd),
    }


@pytest.mark.parametrize("name", ["lstm_cell", "lstm_seq", "lstm_stack", "wkv6",
                                  "flash_attention"])
def test_kernel_meta_op_counts_the_plain_versions_flops(name):
    """On meta tensors a kernel's wrapper runs one op (no loop) whose
    FLOPs equal FlopCounterMode over the plain version on the CPU, read
    both by FlopCounterMode and by the trace; its bytes are its inputs and
    outputs, once."""
    makers, plain, wrapper, want = _kernel_cases()[name]
    cpu = [m("cpu") for m in makers]
    meta = [m("meta") for m in makers]
    assert _flop_counter(plain, *cpu) == want
    assert _flop_counter(wrapper, *meta) == want
    _, record = trace(wrapper, *meta)
    kernel = [e for e in record if e["op"].startswith("repro_torch.")]
    assert len(kernel) == 1 and kernel[0]["n"] == 1
    assert analyze(kernel).flops == want
    from repro_torch.roofline.trace import _nbytes
    assert analyze(kernel).bytes == _nbytes(kernel[0]["args"]) + _nbytes(kernel[0]["out"])


def test_wkv6_meta_returns_the_kernels_shapes():
    from repro_torch.kernels import ops

    b, t, h, hd = 2, 4096, 64, 64
    r = torch.empty(b, t, h, hd, dtype=torch.bfloat16, **META)
    w = torch.empty(b, t, h, hd, **META)
    y, s_t = ops.wkv6_op(r, r, r, w, torch.empty(h, hd, **META), torch.empty(b, h, hd, hd, **META))
    assert (y.shape, y.dtype, y.device.type) == ((b, t, h, hd), torch.float32, "meta")
    assert (s_t.shape, s_t.dtype) == ((b, h, hd, hd), torch.float32)


# ------------------------------------------------------------ the reference's parts

def _all_cells():
    """The dry run's cells: the reference's archs (the port's list is theirs
    and moonlight-16b-a3b, which the analytic roofline does not count)."""
    from repro.config import list_archs as jax_list_archs
    from repro_torch.config import get_config, shapes_for

    return [(a, s.name) for a in jax_list_archs() for s in shapes_for(get_config(a))]


def test_port_archs_are_the_references_plus_moonlight():
    from repro.config import list_archs as jax_list_archs
    from repro_torch.config import list_archs

    assert list_archs() == sorted(jax_list_archs() + ["moonlight-16b-a3b"])


@pytest.mark.parametrize("arch", sorted({a for a, _ in _all_cells()}))
def test_active_params_and_model_flops_match_reference(arch):
    from repro.config import get_config as jax_config
    from repro.config import shapes_for as jax_shapes
    from repro.roofline.extract import active_param_count as jax_active
    from repro.roofline.extract import model_flops_estimate as jax_model_flops

    from repro_torch.config import get_config, shapes_for
    from repro_torch.roofline import active_param_count, model_flops_estimate

    cfg, jcfg = get_config(arch), jax_config(arch)
    assert active_param_count(cfg) == jax_active(jcfg)
    shapes, jshapes = shapes_for(cfg), jax_shapes(jcfg)
    assert [s.name for s in shapes] == [s.name for s in jshapes]
    for s, js in zip(shapes, jshapes):
        assert model_flops_estimate(cfg, s) == jax_model_flops(jcfg, js)


def test_active_param_count_orders_of_magnitude():
    from repro_torch.config import get_config
    from repro_torch.roofline import active_param_count

    assert 1.0e9 < active_param_count(get_config("tinyllama-1.1b")) < 1.35e9
    assert 17e9 < active_param_count(get_config("internlm2-20b")) < 23e9
    assert 2e9 < active_param_count(get_config("moonshot-v1-16b-a3b")) < 5e9
    assert 30e9 < active_param_count(get_config("dbrx-132b")) < 45e9


def _records():
    """Cell records as both packages write them: ok cells with every
    dominant term, a failed cell, one without a collective breakdown."""
    base = dict(mesh="single_pod_16x16", chips=256, flops_per_chip=1e12, bytes_per_chip=2e9,
                coll_bytes_per_chip=1e8, model_flops=2e14, flops_ratio=0.781234,
                memory_analysis=None, note="", status="ok", compile_s=1.0)
    rows = [
        dict(base, arch="tinyllama-1.1b", shape="train_4k", compute_s=0.5, memory_s=0.25,
             collective_s=0.125, dominant="compute", coll_breakdown={"all-gather": 7}),
        dict(base, arch="tinyllama-1.1b", shape="decode_32k", compute_s=1e-5, memory_s=0.0123,
             collective_s=4e-4, dominant="memory", coll_breakdown={}),
        dict(base, arch="olmo-1b", shape="prefill_32k", compute_s=1.5, memory_s=3.25,
             collective_s=0.5, dominant="memory", coll_breakdown={"reduce-scatter": 3}),
        dict(base, arch="olmo-1b", shape="train_4k", compute_s=0.1, memory_s=0.2,
             collective_s=0.9, dominant="collective",
             coll_breakdown={"all-gather": 5, "all-reduce": 9}),
        dict(base, arch="rwkv6-7b", shape="long_500k", compute_s=1e-6, memory_s=2e-3,
             collective_s=1e-3, dominant="memory"),
        dict(base, arch="jamba-v0.1-52b", shape="train_4k", compute_s=0.0, memory_s=0.0,
             collective_s=0.0, dominant="collective"),
    ]
    failed = {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "single_pod_16x16",
              "status": "error: Cannot unflatten unevenly sharded tensor: output dimension 0",
              "compile_s": 3.0}
    return rows + [failed]


def test_render_table_byte_equal_to_reference(tmp_path):
    from repro.roofline.report import render_table as jax_render

    from repro_torch.roofline.report import render_table

    for r in _records():
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(r))
    (tmp_path / "x__y__multi_pod_2x16x16.json").write_text(json.dumps(_records()[0]))
    got = render_table(str(tmp_path))
    assert got == jax_render(str(tmp_path))
    assert got.count("\n") == 2 + len(_records()) - 1
    assert "FAILED: error: Cannot unflatten" in got


def test_report_of_a_record_has_the_reference_fields():
    import dataclasses

    from repro.roofline.extract import RooflineReport as JaxReport

    from repro_torch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS_BY_DTYPE, RooflineReport, build_report

    ours = {f.name for f in dataclasses.fields(RooflineReport)}
    assert {f.name for f in dataclasses.fields(JaxReport)} <= ours
    _, record = trace(lambda x, y: (x @ y).float() @ torch.empty(32, 8, **META),
                      torch.empty(64, 16, dtype=torch.bfloat16, **META),
                      torch.empty(16, 32, dtype=torch.bfloat16, **META))
    rep = build_report(arch="a", shape="s", mesh_name="m", chips=4, record=record,
                       model_flops=1.0)
    bf16, f32 = 2 * 64 * 16 * 32, 2 * 64 * 32 * 8
    assert rep.flops_by_dtype == {"bfloat16": bf16, "float32": f32}
    np.testing.assert_allclose(rep.compute_s, bf16 / PEAK_FLOPS_BY_DTYPE["bfloat16"]
                               + f32 / PEAK_FLOPS_BY_DTYPE["float32"], rtol=1e-12)
    np.testing.assert_allclose(rep.memory_s, rep.bytes_per_chip / HBM_BW, rtol=1e-12)
    assert rep.collective_s == rep.coll_bytes_per_chip / LINK_BW == 0.0
    assert rep.dominant == "memory" and rep.flops_ratio == 1.0 / (4 * (bf16 + f32))
    # H100 80GB HBM3 datasheet figures; no TPU figure
    assert (PEAK_FLOPS_BY_DTYPE["bfloat16"], PEAK_FLOPS_BY_DTYPE["float32"], HBM_BW,
            LINK_BW) == (989e12, 67e12, 3.35e12, 50e9)


def test_diagnose_ranks_by_each_term():
    from repro_torch.roofline.diagnose import top_contributors

    def step(x, w):
        for _ in range(3):
            x = torch.tanh(x @ w)
        return x

    _, record = trace(step, torch.empty(128, 256, **META), torch.empty(256, 256, **META))
    flops = top_contributors(record, k=3, kind="flops")
    assert flops[0][1] == "aten.mm.default" and flops[0][0] == 3 * 2 * 128 * 256 * 256
    assert flops[0][3] == 3
    by_bytes = top_contributors(record, k=5, kind="bytes")
    assert [v for v, *_ in by_bytes] == sorted((v for v, *_ in by_bytes), reverse=True)
    assert top_contributors(record, kind="collective") == []


def test_trace_mode_leaves_no_mode_behind():
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    with pytest.raises(ValueError):
        with OpTrace():
            raise ValueError("inside")
    assert _get_current_dispatch_mode() is None
