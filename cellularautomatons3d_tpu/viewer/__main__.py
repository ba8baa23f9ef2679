"""python -m cellularautomatons3d_tpu.viewer [--port 8000] [--grid 64] ..."""

import argparse

from .server import serve


def main():
    p = argparse.ArgumentParser(description="interactive CA viewer")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--preset", type=str, default=None)
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard the engine over an N-device 1-D mesh (config 5: "
        "z-sharded CA step + row-sharded render).  On a host with fewer "
        "devices, combine with JAX_PLATFORMS=cpu "
        "XLA_FLAGS=--xla_force_host_platform_device_count=N",
    )
    args = p.parse_args()
    overrides = dict(grid_size=args.grid, width=args.width, height=args.height)
    if args.mesh:
        overrides["mesh_devices"] = args.mesh
    if args.preset:
        from ..models.presets import PRESETS

        overrides.update(PRESETS[args.preset])
    serve(port=args.port, **overrides)


if __name__ == "__main__":
    main()
