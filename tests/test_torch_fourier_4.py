"""The fourier BSDF in every integrator of the port, on the CPU, in the
manner of tpurt's test_fourier_consistent_across_integrators: the tiny
Ptex scene's mesh under a Lambertian fourier table of reflectance 0.8
renders within 10% of the same mesh under matte 0.8 through path, bdpt
and sppm, and well above matte 0.5, the gray stand-in that the fourier
rows carry in their lobe columns.  So each integrator shades fourier
lanes with the tabulated BSDF (sppm counts them as glossy at its visible
points), as tpurt's do.
"""

import torch

from torch_lens_fourier_scenes import ptex_fourier_tiny, write_inputs

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_fourier_shades_with_its_table_in_path_bdpt_and_sppm(tmp_path):
    from tpurt_torch.render.driver import render
    from tpurt_torch.render.fourier import (make_lambertian_table,
                                            write_bsdf_file)
    from tpurt_torch.scene import load_scene_string

    files = write_inputs(tmp_path)
    write_bsdf_file(files["bsdf"], make_lambertian_table(0.8, n_mu=24))
    fourier = f'Material "fourier" "string bsdffile" ["{files["bsdf"]}"]'
    for integ in ("path", "bdpt", "sppm"):
        text = ptex_fourier_tiny(files, integrator=integ, res=16, spp=16)
        means = {}
        for name, mat in (("fourier", fourier),
                          ("matte", 'Material "matte" "color Kd" [.8 .8 .8]'),
                          ("gray", 'Material "matte" "color Kd" [.5 .5 .5]')):
            img, _ = render(load_scene_string(text.replace(fourier, mat)),
                            "cpu")
            means[name] = float(img.mean())
        assert abs(means["fourier"] / means["matte"] - 1) < 0.1, (integ,
                                                                   means)
        assert means["gray"] < 0.85 * means["fourier"], (integ, means)
