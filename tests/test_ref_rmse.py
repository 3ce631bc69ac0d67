"""Gated end-to-end fidelity test against the REAL reference binary.

tests/golden/ref_binary/*.png were rendered by the reference's own code
(benchmarks/ref_bench.cpp compiles /root/reference headers read-only and
the reference's camera/wpng path writes the PNG, src/camera.h:139-142).
This guards against transcription bugs in tests/oracle.py — the other
fidelity tests all route through our own transcription.

Runs on CPU at a small config by default (minutes); set BPT_REF_RMSE_FULL=1
to run the recorded 256x256 configs (a GPU recommended).  The tolerance is
MC noise between two independent equal-spp renders plus a small margin;
tools/ref_rmse.py reports the recorded full-config numbers (BASELINE.md).
"""

import os

import numpy as np
import pytest


@pytest.mark.skipif(
    not os.path.exists(os.path.join(os.path.dirname(__file__), "golden",
                                    "ref_binary", "ref_pt_256_256.png")),
    reason="reference-binary goldens missing (run benchmarks/ref_bench)",
)
def test_pt_matches_reference_binary_crop():
    """Compare a downsampled view (8x8 box means) of our PT render against
    the reference binary's: downsampling averages away most MC noise, so
    the comparison is tight even at CPU-affordable spp."""
    import dataclasses

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu.utils.png import read_png

    gold = read_png(
        os.path.join(os.path.dirname(__file__), "golden", "ref_binary",
                     "ref_pt_256_256.png")
    ).astype(np.float64) / 255.0

    full = os.environ.get("BPT_REF_RMSE_FULL", "") == "1"
    spp = 256 if full else 25
    scene = cornell_box()
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=256, samples_per_pixel=spp,
        max_depth=10, integrator="pt",
    )
    ours = render(scene, cfg, seed=0).rgb8().astype(np.float64) / 255.0

    def down(img, f=8):
        h, w, c = img.shape
        return img.reshape(h // f, f, w // f, f, c).mean((1, 3))

    rmse_ds = float(np.sqrt(np.mean((down(ours) - down(gold)) ** 2)))
    # 8x8-downsampled MC noise at 25 spp is ~1%; the reference image at
    # 256 spp contributes ~0.3%.  Structural errors (wrong wall color,
    # shifted box, brightness scale) show up at the several-% level.
    tol = 0.01 if full else 0.02
    assert rmse_ds < tol, f"downsampled RMSE {rmse_ds:.4f} vs {tol}"


def test_bdpt_matches_reference_binary_crop():
    """Same downsampled comparison for the de-facto reference integrator:
    both main.cpp call sites dispatch to BDPT (src/camera.h:245-253), so
    the estimator that defines the reference's output must be binary-
    validated, not just oracle-validated.  Golden: cornell 256x256,
    64 spp, depth 10 via benchmarks/ref_bench.cpp (the reference's own
    camera/integrator/BVH/wpng).

    Wiring this test up (round 3) found that the reference's visible()
    (camera.h:425-438) REJECTS ~86% of genuinely-unoccluded connections:
    the endpoint's surface sits exactly at max_t and the inclusive fp
    comparison usually resolves "occluded" (tools/probe_ref_vis.md,
    docs/PARITY.md).  The comparison therefore runs with ref_vis=True
    (endpoint-artifact emulation); the default estimator implements the
    intended semantics and is ~1.4x brighter than the binary."""
    import dataclasses

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu.utils.png import read_png

    path = os.path.join(os.path.dirname(__file__), "golden", "ref_binary",
                        "ref_bdpt_256_64.png")
    assert os.path.exists(path), f"committed golden missing: {path}"
    gold = read_png(path).astype(np.float64) / 255.0

    full = os.environ.get("BPT_REF_RMSE_FULL", "") == "1"
    spp = 64 if full else 16
    scene = cornell_box()
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=256, samples_per_pixel=spp,
        max_depth=10, integrator="bdpt", ref_vis=True,
    )
    ours = render(scene, cfg, seed=0).rgb8().astype(np.float64) / 255.0

    def down(img, f=8):
        h, w, c = img.shape
        return img.reshape(h // f, f, w // f, f, c).mean((1, 3))

    rmse_ds = float(np.sqrt(np.mean((down(ours) - down(gold)) ** 2)))
    # residual (measured 0.038 at 16 spp): our XLA-f64 M-T resolves the
    # endpoint fp ties at 12.6% acceptance vs the strict-IEEE binary's
    # 13.6% (XLA FMA contraction shifts ulp-level ties) -> connection
    # transport ~5% dim globally.  The tolerance still catches any
    # structural estimator error (the un-emulated default measures 0.14).
    tol = 0.045
    assert rmse_ds < tol, f"downsampled RMSE {rmse_ds:.4f} vs {tol}"


def test_bdpt_default_vs_binary_brightness_band():
    """The DEFAULT BDPT estimator (intended
    visible() semantics, ref_vis=False) pinned DIRECTLY against the reference
    binary's output, not only through the ref_vis-emulated chain.  The
    documented relationship: the binary's endpoint-tie artifact darkens
    its connection transport, so our default renders ~1.40x brighter
    (tonemapped means) with a downsampled RMSE of ~0.142 (measured at
    16 spp, seed 0).  The band bounds both sides: a structural estimator
    regression moves the RMSE out of band, and 'accidentally emulating
    the artifact' (or double-brightening) moves the mean ratio."""
    import dataclasses

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.presets import cornell_box, cornell_box_camera
    from bpt_tpu.utils.png import read_png

    path = os.path.join(os.path.dirname(__file__), "golden", "ref_binary",
                        "ref_bdpt_256_64.png")
    assert os.path.exists(path), f"committed golden missing: {path}"
    gold = read_png(path).astype(np.float64) / 255.0

    scene = cornell_box()
    cfg = dataclasses.replace(
        cornell_box_camera(), image_width=256, samples_per_pixel=16,
        max_depth=10, integrator="bdpt",
    )
    ours = render(scene, cfg, seed=0).rgb8().astype(np.float64) / 255.0

    def down(img, f=8):
        h, w, c = img.shape
        return img.reshape(h // f, f, w // f, f, c).mean((1, 3))

    rmse_ds = float(np.sqrt(np.mean((down(ours) - down(gold)) ** 2)))
    ratio = float(ours.mean() / gold.mean())
    assert 0.10 < rmse_ds < 0.18, f"default-vs-binary RMSE {rmse_ds:.4f}"
    assert 1.30 < ratio < 1.50, f"tonemapped mean ratio {ratio:.3f}"


@pytest.mark.skipif(
    os.environ.get("BPT_REF_RMSE_FULL", "") == "",
    reason="north-star glass config takes minutes (set BPT_REF_RMSE_FULL=1)",
)
def test_glass_northstar_matches_reference_binary():
    """North-star scene class vs the REAL reference binary: the glass
    stand-in (510 tris, depth 80, dielectric stack) rendered by
    benchmarks/ref_glass_bench.cpp through the reference's own
    camera/integrator/BVH (golden: ref_glass_640_64_d80.png).  Recorded
    result: 8x8-downsampled RMSE 0.87% at 64 spp, means within 0.06%
    (BASELINE.md north-star criterion: <= 1%)."""
    import dataclasses

    from bpt_tpu.models.render import render
    from bpt_tpu.scene.loader import load_scene_from_yaml
    from bpt_tpu.utils.png import read_png
    from bpt_tpu.ops.film import to_rgb8

    here = os.path.dirname(__file__)
    ref = np.asarray(
        read_png(os.path.join(here, "golden", "ref_binary",
                              "ref_glass_640_64_d80.png")), np.float32)
    ls = load_scene_from_yaml(os.path.join(here, "..", "scenes", "glass",
                                           "glass_standin.yaml"))
    cfg = dataclasses.replace(ls.camera, aspect_ratio=640 / 360,
                              image_width=640, samples_per_pixel=64,
                              max_depth=80, integrator="pt")
    r = render(ls.scene, cfg, seed=0)
    ours = np.asarray(
        to_rgb8(r.framebuffer_sum, r.samples_per_pixel), np.float32)

    def ds(x, f=8):
        h, w = x.shape[0] // f * f, x.shape[1] // f * f
        return x[:h, :w].reshape(h // f, f, w // f, f, 3).mean((1, 3))

    rmse = float(np.sqrt(((ds(ref) - ds(ours)) ** 2).mean()))
    assert rmse / 255.0 <= 0.015, f"RMSE {rmse/255:.4f} > 1.5%"
