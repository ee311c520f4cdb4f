from vrenderer_pathtracer.cli import run

raise SystemExit(run())
