"""The fusion's share of the card's dense bf16 peak in the traced
stretch: the configuration's analytic FLOPs of its fusion a call
(``configs/<name>/flops.py::fusion``, never the program's own count) over
the device seconds a call of the port's span
``det.predict/det.model/det.fuse`` (the warp, the masks and the
transformer), over the peak. None where the configuration's count has no
``fusion``."""

from benchmark.harness.cell import ROOT, load_file, load_json
from benchmark.harness.readers import span_per_call

FUSE = "det.predict/det.model/det.fuse"


def read(r):
    if r.peaks is None:
        return None
    files = {c["name"]: c["file"] for c in load_json(ROOT / "BENCHMARK.json")["configs"]}
    path = files.get(r.config["name"])
    if path is None:
        return None
    flops = load_file((ROOT / path).parent / "flops.py", f"flops_{r.config['name']}")
    seconds = span_per_call(r, [FUSE], "device_s", "det.predict")
    if not hasattr(flops, "fusion") or not seconds:
        return None
    return 100.0 * flops.fusion(r.config, r.batch) / seconds / r.peaks["bf16_flops"]
