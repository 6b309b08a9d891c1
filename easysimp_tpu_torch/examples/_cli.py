"""The command line the examples share: their positional arguments, each
optional after the first optional one, and `--device`."""

from __future__ import annotations

import argparse


def run(main, *positional, required=(), doc=None, options=None):
    """main(*given positional arguments, device=..., **options) from
    sys.argv.  `required` names the positional arguments that must be
    given (they come first); `options` maps an option name to its type
    (default None: main's own default)."""
    parser = argparse.ArgumentParser(
        description=(doc or "").strip().splitlines()[0] if doc else None)
    for name in required:
        parser.add_argument(name)
    for name in positional:
        parser.add_argument(name, nargs="?")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    for name, kind in (options or {}).items():
        parser.add_argument(f"--{name}", type=kind, default=None)
    args = parser.parse_args()
    given = [getattr(args, n) for n in (*required, *positional)]
    while given and given[-1] is None:
        given.pop()
    extra = {k: getattr(args, k) for k in (options or {})
             if getattr(args, k) is not None}
    return main(*given, device=args.device, **extra)

