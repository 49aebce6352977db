"""The reference against the program's plain path on the CPU, and the
harness's arithmetic that the reference and the roofline rest on."""

import numpy as np
import pytest
import torch

from small import FIXTURE
from vkbench import manifest, roofline

CUBE = "assets/sponza_replica/pisa_cube.ktx"


def _frames(w, h, mode):
    import reference
    from reference.graph.driver import config_from_settings as ref_cfg
    from vk_renderer_tpu_torch.app.headless import build_scene
    from vk_renderer_tpu_torch.graph import driver
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.scene.camera import Camera
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    root = manifest.ROOT
    kw = dict(enable_shadows=True, shadow_mode=mode, enable_postprocess=True)
    pos = np.array([0.2, 0.1, 1.9], np.float32)
    scene = scene_to_torch(build_scene("s", str(root / FIXTURE),
                                       str(root / CUBE)), "cpu")
    st = RenderSettings(**kw)
    cfg = driver.config_from_settings(st, w, h, shadow_size=256)
    cam = Camera(position=pos, yaw=0.1)
    prog = driver.render(scene, cam, st, cfg)
    rscene = reference.load_scene(str(root / FIXTURE), str(root / CUBE),
                                  "cpu")
    rst = reference.RenderSettings(**kw)
    ref = reference.render(rscene, reference.camera(pos, 0.1), rst,
                           ref_cfg(rst, w, h, shadow_size=256))
    return prog, ref


@pytest.mark.parametrize("mode", [3, 1], ids=["csm", "pcf"])
def test_reference_equals_the_program_plain_path_at_64x32(mode):
    prog, ref = _frames(64, 32, mode)
    assert torch.equal(prog["color_u8"], ref["color_u8"])
    assert torch.equal(prog["depth"], ref["depth"])
    assert torch.equal(prog["stats_vec"], ref["stats_vec"])
    assert int((ref["tid"] >= 0).sum()) > 100


def test_reference_png_decoder_equals_the_program_on_the_replica():
    import struct
    from reference.utils.image import decode_png as ref_decode
    from vk_renderer_tpu_torch.utils.image import decode_png
    data = (manifest.ROOT / "assets/sponza_replica/Sponza.glb").read_bytes()
    sig = b"\x89PNG\r\n\x1a\n"
    start, n = 0, 0
    while n < 6:                      # the first six textures
        start = data.find(sig, start)
        end = data.find(b"IEND", start) + 8
        png = data[start:end]
        assert np.array_equal(ref_decode(png), decode_png(png))
        start, n = end, n + 1
    assert struct.unpack(">I", png[16:20])[0] > 0


def test_bbox_columns_of_a_known_triangle():
    # triangle (10, 2) (40, 2) (10, 20) in tile-local pixels: edges through
    # each pair; columns 10..40 of the tile
    v = [(10.0, 2.0), (40.0, 2.0), (10.0, 20.0)]
    rec = torch.zeros((1, 16))
    for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        (x0, y0), (x1, y1) = v[i], v[j]
        a, b = y0 - y1, x1 - x0
        rec[0, 3 * e:3 * e + 3] = torch.tensor([a, b, -(a * x0 + b * y0)])
    assert int(roofline._bbox_cols(rec, 128)[0]) == 30
    rec[0, 0:9] = 0.0                                 # degenerate
    assert int(roofline._bbox_cols(rec, 128)[0]) == 128


def test_raster_work_counts_only_live_records():
    g = 3
    counts = torch.tensor([0, 65, 3], dtype=torch.int32)
    rec_start = torch.tensor([0, 1, 0], dtype=torch.int32)  # tile 2: 0
    records = torch.zeros((3, 8, 128))
    flat = records.reshape(-1, 16)
    flat[:, 13] = 0 * 256 + 8          # rows 0..8 of the tile
    flat[:, 0:9] = torch.tensor([0., 1, -1, 1, 0, -1, 1, 1, -300])
    n_bytes, ops = roofline.raster_work(records, rec_start, counts,
                                        [torch.zeros(g, 32, 128)], 8, 32, 128)
    cols = int(roofline._bbox_cols(flat[:1], 128)[0])
    assert float(ops) == (65 + 3) * 8 * cols * roofline.RASTER_OPS
    assert float(n_bytes) == (3 * 64 * 16 * 4 + 8 * g + 4 * g * 32 * 128
                              + 8 * g * 32 * 128)
    assert roofline.bound_s(1e9, 0.0) == pytest.approx(1e9 / 3.35e12)
    bound = roofline.raster_bound_s(records, rec_start, counts,
                                    [torch.zeros(g, 32, 128)], 8, 32, 128)
    assert float(bound) == pytest.approx(roofline.bound_s(float(n_bytes),
                                                          float(ops)))


def test_spans_name_the_innermost_open_span():
    from vkbench.trace import Spans
    s = Spans([("bench.frame", 0, 100), ("bench.masked", 10, 50),
               ("bench.own", 20, 30), ("bench.pull", 60, 90)])
    assert s.name_at(25) == "bench.own"
    assert s.name_at(40) == "bench.masked"
    assert s.name_at(55) == "bench.frame"
    assert s.name_at(150) == "outside any span"
    assert s.inside(25, "bench.masked") and not s.inside(70, "bench.own")
