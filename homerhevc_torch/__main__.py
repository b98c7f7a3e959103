"""`python -m homerhevc_torch`: the console app (homerhevc_torch.cli)."""
from homerhevc_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
