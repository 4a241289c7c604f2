"""Pattern creation: initialize_laser in all four modes.

Twin of examples/10_pattern_creation.py: RANDOM, POISSON, GRID and SMARTY
(depth-variance map -> radius map -> blue noise -> reprojection).
"""

import torch

from _common import device, out_dir

from fireflies_tpu_torch.assets import scenes
from fireflies_tpu_torch.estimation import LaserConfig, initialize_laser
from fireflies_tpu_torch.render import RenderConfig, SceneBridge
from fireflies_tpu_torch.utils.png import write_png

if __name__ == "__main__":
    dev = device()
    scene, kwargs = scenes.vocalfold(resolution=16, n_anim_frames=4)
    bridge = SceneBridge(scene, **kwargs)
    cfg = LaserConfig(
        n_beams=150, n_depthmaps=8, image_size=(128, 128),
        smarty_min_radius=4.0, smarty_max_radius=24.0,
    )
    rcfg = RenderConfig(width=128, height=128, spp=1, max_bounces=1, tri_chunk=256)

    d = out_dir("10_pattern_creation")
    for mode in ["RANDOM", "POISSON", "GRID", "SMARTY"]:
        with torch.no_grad():
            laser = initialize_laser(
                scene, bridge, cfg, mode=mode, gen=torch.Generator(device=dev).manual_seed(0),
                render_config=rcfg, device=dev,
            )
            tex = laser.generate_texture_summed(20.0, (256, 256))
        write_png(str(d / f"pattern_{mode.lower()}.png"), tex.cpu().numpy())
        laser.save(str(d / f"laser_{mode.lower()}.yml"))
        print(f"{mode}: {laser.local_rays().shape[0]} beams")
    print("wrote patterns to", d)
