"""postprocess-compatible CLI (pp/main.c:19-71, postproc.c:36-92), as in
``c_raytracer_tpu.cli.postprocess``.

  postprocess <input.tif> <output.tif> [flags]

  -b (float)                    brighten factor
  --dof (scale) (bias)          depth of field
  --dof-camera (aperture) (focal_length) (plane_in_focus)
  --mist (start) (depth) (quad|lin|inv-quad) (r) (g) (b)
  --device (str)                torch device, DEFAULT cuda (no fallback)

Effects are applied in the reference's order: brighten → dof → mist.
Input must be the raw float32 TIFF with z-buffer tag written by engine -f.
Run as ``python -m c_raytracer_tpu_torch.cli.postprocess``.
"""

from __future__ import annotations

import sys


def _flag(argv, name, nargs):
    if name in argv:
        i = argv.index(name)
        return argv[i + 1:i + 1 + nargs]
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv or len(argv) < 2:
        print(__doc__)
        return 0 if ("--help" in argv or "-h" in argv) else 1

    from c_raytracer_tpu_torch.core.logging import init as log_init, printf_log
    log_init()

    import torch

    from c_raytracer_tpu_torch.image import read_tiff, write_tiff_rgb8
    from c_raytracer_tpu_torch.postprocess import (
        brighten, depth_of_field, dof_camera_params, mist)

    inp, outp = argv[0], argv[1]
    v = _flag(argv, "--device", 1)
    device = torch.device(v[0] if v else "cuda")
    img, z = read_tiff(inp)
    if z is None:
        print(f"Failed to read z-buffer from [{inp}] "
              "(expected raw output of engine -f).")
        return 1
    h, w, _ = img.shape
    image = torch.from_numpy(img).to(device)
    zb = torch.from_numpy(z.reshape(h, w)).to(device)

    printf_log("Commencing Postprocessing")
    v = _flag(argv, "-b", 1)
    if v:
        printf_log("Brightening by factor %f.", float(v[0]))
        image = brighten(image, float(v[0]))

    v = _flag(argv, "--dof", 2)
    if v:
        scale, bias = float(v[0]), float(v[1])
        printf_log("Applying depth of field with scale [%f] and bias [%f].",
                   scale, bias)
        image = depth_of_field(image, zb, scale, bias)
    else:
        v = _flag(argv, "--dof-camera", 3)
        if v:
            scale, bias = dof_camera_params(
                zb, float(v[0]), float(v[1]), float(v[2]))
            printf_log(
                "Applying depth of field with scale [%f] and bias [%f].",
                scale, bias)
            image = depth_of_field(image, zb, scale, bias)

    v = _flag(argv, "--mist", 6)
    if v:
        # reference tokens (pp/main.c:41, postproc.c:78-88 hash 624812280
        # == djb2("inv-quad")); "inv_quad" kept as a courtesy alias
        falloff = {"quad": "quad", "lin": "lin",
                   "inv-quad": "inv_quad", "inv_quad": "inv_quad"}.get(v[2])
        if falloff is None:
            print(f"Unrecognized falloff type [{v[2]}].")
            return 1
        image = mist(image, zb, float(v[0]), float(v[1]), falloff,
                     [float(v[3]), float(v[4]), float(v[5])])

    write_tiff_rgb8(outp, image.cpu().numpy())
    printf_log("Terminating.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
