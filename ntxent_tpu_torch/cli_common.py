"""What the torch command line (``cli``) and the torch-free fleet command
line (``fleet_cli``) share: the ``--model`` choices, the ``--platform``
mapping and the exit on a flag that is not ported yet. Stdlib only: the
fleet's router process imports it."""

from __future__ import annotations

__all__ = ["MODEL_CHOICES", "PLATFORM_DEVICES", "exit_on_unported"]

# The JAX CLI's --model choices.
MODEL_CHOICES = ["resnet18", "resnet34", "resnet50", "resnet50x2",
                 "resnet101", "resnet152", "vit_t16", "vit_s16",
                 "vit_b16", "vit_l16", "tiny"]

# The JAX CLI's --platform values the port runs on, and the device each
# selects.
PLATFORM_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def exit_on_unported(prog: str, args, table, items) -> None:
    """Exit naming the item of the first flag of ``table`` (dest, default,
    item) that is set to anything but its default."""
    for dest, default, item in table:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{prog}: {flag} is not ported yet: "
                             f"{items[item]}")
