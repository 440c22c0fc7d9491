"""The ``cobevt`` configuration on the CPU at the harness's small size
(``small.shrink``, window 4 on its 8x8 stage-3 maps: 2x2 windows and
grid groups 2 pixels apart, 96-token sequences): the file's ``fusion``
block reaches the port; the weight draw puts the local and grid
attention logits at unit scale; the configuration's reference and the
port agree in float32 through ``check.py``'s prediction numbers;
``flops.fusion`` is the hand count; each new per-layer metric reads its
span, and nothing where the span is absent."""

import math

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import check, program, spans, trace
from benchmark.harness.cell import BENCH, Reading, load_file
from benchmark.harness.flopcount import backbone
from benchmark.harness.weights import make_state_dict
from benchmark.reference import detect
from small import SEED, shrink
from test_harness_spans import Canned

CPU = torch.device("cpu")
CELL = "cobevt_predict"
PEAKS = {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _cell(**fusion):
    c = C.load_cell(CELL)
    shrink(c)
    c.config["fusion"]["window_size"] = 4
    c.config["fusion"].update(fusion)
    return c


def _build(c):
    return program.build(c.config, make_state_dict(C.skeleton(c), SEED, CPU), CPU)


def test_the_file_builds_the_ports_cobevt_fusion():
    c = _cell()
    f = c.config["fusion"]
    fusion = _build(c).model.fusion
    assert type(fusion).__name__ == "CoBEVTFusion" and len(fusion.layers) == f["depth"] == 3
    layer = fusion.layers[0]
    for attn in (layer.local_attn, layer.grid_attn):
        assert (attn.heads, attn.dim_head, attn.window) == (64 // f["dim_head"], f["dim_head"], 4)
        assert attn.dropout == f["dropout"]
        assert attn.relative_position_bias_table.num_embeddings == 11 * 7 * 7
    assert layer.local_ffn.fc1.out_features == layer.grid_ffn.fc1.out_features == f["mlp_dim"]
    assert fusion.window_size == 4


def test_each_key_is_applied():
    assert len(_build(_cell(depth=2)).model.fusion.layers) == 2
    assert _build(_cell(dim_head=16)).model.fusion.layers[0].local_attn.heads == 4
    assert _build(_cell(mlp_dim=128)).model.fusion.layers[0].grid_ffn.fc1.out_features == 128
    assert _build(_cell(dropout=0.3)).model.fusion.layers[0].grid_attn.dropout == 0.3
    assert _build(_cell(window_size=2)).model.fusion.layers[1].grid_attn.window == 2


def test_a_key_the_port_does_not_take_raises():
    with pytest.raises(ValueError, match="no fusion key"):
        _build(_cell(heads=8))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attention_logits_have_unit_scale(seed):
    c = _cell()
    ref = C.skeleton(c).fusion.to_empty(device=CPU)
    ref.load_state_dict({k[len("fusion."):]: v for k, v in
                         make_state_dict(C.skeleton(c), seed, CPU).items()
                         if k.startswith("fusion.")})
    layer = ref.layers[0]
    x = torch.randn(2, 6, 8, 8, 64, generator=torch.Generator().manual_seed(seed))
    stds = []
    with torch.no_grad():
        for norm, attn in ((layer.local_norm, layer.local_attn),
                           (layer.grid_norm, layer.grid_attn)):
            q, k, _ = attn.to_qkv(norm(x)).chunk(3, dim=-1)
            m, d = attn.heads, attn.dim_head
            # Any partition scores the same pairs' distribution: the whole
            # 8x8 map's tokens against each other, per head.
            q, k = (t.reshape(2, -1, m, d).transpose(1, 2) for t in (q, k))
            stds.append(float((q @ k.transpose(-1, -2) / math.sqrt(d)).std()))
            stds.append(float(attn.relative_position_bias_table.weight.std()))
    assert all(0.5 < s < 2.0 for s in stds), stds


def test_the_reference_and_the_port_agree_in_float32():
    c = _cell()
    c.config["precision"]["activations"] = "float32"
    pool = C.make_pool(c, SEED, CPU)
    sd = make_state_dict(C.skeleton(c), SEED, CPU)
    module = program.build(c.config, sd, CPU)
    ref = C.reference_model(c, sd, CPU).eval()
    batch = pool[0]
    with torch.no_grad():
        occ = detect.voxelize(batch["points"], batch["point_mask"], c.config)
        want = ref(occ, batch["trans"], batch["agent_mask"].bool())
        got = module.model(module.model_input(module.to_device(batch)), batch["trans"],
                           batch["agent_mask"].bool())
    for a, b in zip(want, (got.cls_logits, got.reg)):
        assert (a - b).abs().max() <= 1e-4 * max(1.0, float(a.abs().max()))
    t = c.traffic
    out = module.predict(batch, t["max_boxes"], t["nms_iou"], t["score_threshold"])
    dets, dense = detect.predict(ref, batch, c.config, t["max_boxes"], t["nms_iou"],
                                 t["score_threshold"])
    numbers = check.predict_numbers([detect.Detections(*out)], [dets], [dense], c.config, t)
    assert numbers["box_gap"] < 1e-3 and numbers["select_gap"] < 1e-4
    assert numbers["count_gap"] == 0.0 and numbers["nms_errors"] == 0.0


def test_the_fusion_count_is_the_hand_count():
    c = _cell()
    flops = c.flops()
    # A token a layer, C 64, window 4 over 6 slots (N 96): an attention
    # 2 C 3C + 2 C C + 4 N C = 24,576 + 8,192 + 24,576; an FFN 4 C 256.
    assert flops.per_token(c.config) == 2 * 57_344 + 2 * 65_536 == 245_760
    # 2 scenes x 6 egos x 8 x 8 pixels, 6 slots each, three layers; the
    # head 2 C^2 a pixel.
    assert flops.fusion(c.config, 2) == 3 * 4_608 * 245_760 + 768 * 8_192 == 3_403_677_696
    assert flops.predict(c.config, 2) == flops.fusion(c.config, 2) + backbone(c.config, 2)[0]
    full = C.load_cell(CELL)
    assert full.flops().fusion(full.config, 16) == 4_187_593_113_600


FUSE = "det.predict/det.model/det.fuse"
METRICS = {"fax_local_ms.predict": "det.fuse.fax_local", "fax_grid_ms.predict": "det.fuse.fax_grid",
           "ffn_ms.predict": "det.fuse.ffn"}
PARTS = ("det.fuse.fax_local", "det.fuse.ffn", "det.fuse.fax_grid", "det.fuse.ffn")


def _trace(calls=2, layers=3):
    t = Canned()
    t.span("bench.window", 0, 1000 * calls + 10)
    for s in range(calls):
        o = 1000 * s
        t.span("bench.predict", o, 900)
        t.span("det.predict", o + 1, 890)
        t.span("det.model", o + 10, 700)
        t.span("det.fuse", o + 20, 600)
        t.span("det.fuse.warp", o + 21, 30)
        t.launch(o + 22, o + 25, 20, "grid_sampler_2d")
        for i in range(layers):
            base = o + 60 + 160 * i
            for j, name in enumerate(PARTS):
                t.span(name, base + 40 * j, 35)
                t.launch(base + 40 * j + 1, base + 40 * j + 5, 10 * (j + 1), "gemm")
        t.span("det.fuse.head", o + 560, 50)
        t.launch(o + 561, o + 565, 7, "layer_norm")
        t.span("det.heads", o + 630, 60)
        t.launch(o + 631, o + 640, 40, "conv")
        t.span("bench.sync", o + 900, 15)
        t.sync(o + 901, "cudaDeviceSynchronize")
    return t.events


def _reading(events, config_cell=CELL, peaks=PEAKS):
    c = C.load_cell(config_cell)
    summary = trace.summarize(events) if events is not None else None
    return Reading(c.config, c.traffic, 16, 10, 2.0, 10 ** 14, peaks, {}, summary)


def _read(name, r):
    return load_file(BENCH / "metrics" / f"{name}.py", name).read(r)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_part_metric_reads_its_span(name):
    events = _trace()
    got = _read(name, _reading(events))
    want = spans.span_totals(events)[f"{FUSE}/{METRICS[name]}"]["device_s"] * 1e3 / 2
    each = sum(10 * (j + 1) for j, part in enumerate(PARTS) if part == METRICS[name])
    assert got == pytest.approx(want) == pytest.approx(3 * each * 1e-3)
    assert _read(name, _reading(None)) is None
    assert _read(name, _reading([e for e in events if e["name"] != METRICS[name]])) is None


def test_the_fusion_mfu_reads_the_fusion_span_and_the_count():
    events = _trace()
    c = C.load_cell(CELL)
    seconds = spans.span_totals(events)[FUSE]["device_s"] / 2
    want = 100.0 * c.flops().fusion(c.config, 16) / seconds / PEAKS["bf16_flops"]
    assert _read("fusion_mfu_pct.predict", _reading(events)) == pytest.approx(want)
    assert _read("fusion_mfu_pct.predict", _reading(None)) is None
