"""The ``v2xvit`` configuration on the CPU at the harness's small size
(``small.shrink``, windows 2, 4 and 8 on its 8x8 stage-3 maps): the file's
``fusion`` block reaches the port; the weight draw puts HMSA's and MSwin's
logits at unit scale; the configuration's reference and the port agree in
float32 through ``check.py``'s prediction numbers; ``flops.fusion`` is the
hand count; each new per-layer metric reads its span, and nothing where
the span is absent."""

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
CELL = "v2xvit_predict"
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
    c.config["fusion"]["window_sizes"] = [2, 4, 8]
    c.config["fusion"].update(fusion)
    return c


def _build(c):
    return program.build(c.config, make_state_dict(C.skeleton(c), SEED, CPU), CPU)


def test_the_file_builds_the_ports_v2xvit_fusion():
    c = _cell()
    f = c.config["fusion"]
    fusion = _build(c).model.fusion
    assert type(fusion).__name__ == "V2XViTFusion" and len(fusion.layers) == f["depth"] == 3
    layer = fusion.layers[0]
    assert (layer.hmsa.heads, layer.hmsa.dim_head) == (f["heads"], f["dim_head"])
    assert [(w.heads, w.dim_head, w.window) for w in layer.mswin.windows] == list(
        zip(f["window_heads"], f["window_dim_heads"], f["window_sizes"]))
    assert layer.ffn.fc1.out_features == f["mlp_dim"] and layer.hmsa.dropout == f["dropout"]
    assert fusion.rte is not None and fusion.rte_ratio == f["rte_ratio"] and fusion.use_roi_mask


def test_each_key_is_applied():
    assert len(_build(_cell(depth=2)).model.fusion.layers) == 2
    assert _build(_cell(use_roi_mask=False)).model.fusion.use_roi_mask is False


def test_a_key_the_port_does_not_take_raises():
    with pytest.raises(ValueError, match="no fusion key"):
        _build(_cell(bogus=1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attention_logits_have_unit_scale(seed):
    c = _cell()
    ref = C.skeleton(c).fusion.to_empty(device=CPU)
    ref.load_state_dict({k[len("fusion."):]: v for k, v in
                         make_state_dict(C.skeleton(c), seed, CPU).items()
                         if k.startswith("fusion.")})
    layer = ref.layers[0]
    x = torch.randn(2, 6, 8, 8, 64, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        y = layer.hmsa_norm(x)
        h = layer.hmsa
        q = h.q_linears[0](y).reshape(2, 6, 8, 8, h.heads, h.dim_head)
        k = h.k_linears[0](y).reshape(2, 6, 8, 8, h.heads, h.dim_head)
        logits = torch.einsum("bjxymp,mpq,bkxymq->bxymjk", q, h.relation_att[0], k)
        stds = [float(logits.std() / math.sqrt(h.dim_head))]
        y = layer.mswin_norm(x).reshape(-1, 8, 8, 64)
        for w in layer.mswin.windows:
            qw, kw, _ = w.to_qkv(y).chunk(3, dim=-1)
            s, m, d = w.window, w.heads, w.dim_head
            win = lambda t: t.reshape(-1, 8 // s, s, 8 // s, s, m, d).permute(
                0, 1, 3, 5, 2, 4, 6).reshape(-1, m, s * s, d)
            dots = win(qw) @ win(kw).transpose(-1, -2) / math.sqrt(d)
            stds.append(float(dots.std()))
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
    # A token a layer, C 64, HMSA 8 x 32, T 2, A 6: 8 C 256 + 4 T 8 32^2 + 4 A 8 32
    # = 131,072 + 65,536 + 6,144; three branches of 256 wide: 3 x 8 C 256 +
    # 4 (4 + 16 + 64) 256 = 393,216 + 86,016; FFN 4 C 256 = 65,536.
    assert flops.per_token(c.config) == 202_752 + 479_232 + 65_536 == 747_520
    # 2 scenes x 6 egos x 6 maps x 8 x 8 tokens, and 72 maps' split attention
    # (2 C^2 x 4 = 32,768), three layers.
    assert flops.fusion(c.config, 2) == 3 * (4_608 * 747_520 + 72 * 32_768) == 10_340_794_368
    assert flops.predict(c.config, 2) == flops.fusion(c.config, 2) + backbone(c.config, 2)[0]


FUSE = "det.predict/det.model/det.fuse"
METRICS = {"hmsa_ms.predict": "det.fuse.hmsa", "mswin_ms.predict": "det.fuse.mswin",
           "ffn_ms.predict": "det.fuse.ffn"}


def _trace(calls=2, layers=3):
    t = Canned()
    t.span("bench.window", 0, 1000 * calls + 10)
    for s in range(calls):
        o = 1000 * s
        t.span("bench.predict", o, 900)
        t.span("det.predict", o + 1, 890)
        t.span("det.model", o + 10, 700)
        t.span("det.fuse", o + 20, 600)
        t.span("det.fuse.sttf", o + 21, 30)
        t.launch(o + 22, o + 25, 20, "grid_sampler_2d")
        for i in range(layers):
            base = o + 60 + 180 * i
            for j, name in enumerate(("det.fuse.hmsa", "det.fuse.mswin", "det.fuse.ffn")):
                t.span(name, base + 60 * j, 55)
                t.launch(base + 60 * j + 1, base + 60 * j + 5, 10 * (j + 1), "gemm")
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
    j = ["det.fuse.hmsa", "det.fuse.mswin", "det.fuse.ffn"].index(METRICS[name])
    assert got == pytest.approx(want) == pytest.approx(3 * 10 * (j + 1) * 1e-3)
    assert _read(name, _reading(None)) is None
    assert _read(name, _reading([e for e in events if e["name"] != METRICS[name]])) is None


def test_the_fusion_mfu_reads_the_fusion_span_and_the_count():
    events = _trace()
    c = C.load_cell(CELL)
    seconds = spans.span_totals(events)[FUSE]["device_s"] / 2
    want = 100.0 * c.flops().fusion(c.config, 16) / seconds / PEAKS["bf16_flops"]
    assert _read("fusion_mfu_pct.predict", _reading(events)) == pytest.approx(want)
    assert _read("fusion_mfu_pct.predict", _reading(None)) is None
    assert _read("fusion_mfu_pct.predict", _reading(events, peaks=None)) is None
    assert _read("fusion_mfu_pct.predict", _reading([e for e in events
                                                      if e["name"] != "det.fuse"])) is None
    # A configuration whose count has no ``fusion``: nothing to read.
    assert _read("fusion_mfu_pct.predict", _reading(events, "disco_predict")) is None
