"""`python -m pointseg_torch train PointNet++ ...`"""

from pointseg_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
