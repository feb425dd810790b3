"""Entry point mirroring the reference script traj_b0.py (preset: traj_b0).

Same input/output folder conventions and frame schedule as the reference;
all knobs overridable via the unified CLI flags (cli.main).
"""

from pointcloud_render.cli import main as _main


def main(argv=None):
    _main.main(argv, preset_name="traj_b0")


if __name__ == "__main__":
    main()
