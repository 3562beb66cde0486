"""The operator's mesh flag. The device mesh itself (data and tensor
parallelism across cards) is not ported yet (ROADMAP item 15): the port
keeps only the parser of `--mesh` / `ACESTEP_MESH`, a copy of
`acestep_tpu/parallel/mesh.parse_mesh_spec`, so the server and the CLI
reject a malformed spec at once and raise by name on a real mesh."""

from __future__ import annotations

from typing import Optional


def parse_mesh_spec(spec) -> Optional[tuple]:
    """Operator mesh spec -> (dp, tp) or None.

    Accepts 'DPxTP' ('4x2'), a bare integer ('8' = pure data parallel),
    or ''/None/'1'/'1x1' (no mesh)."""
    if spec is None:
        return None
    s = str(spec).strip().lower().replace("*", "x")
    if not s:
        return None
    try:
        if "x" in s:
            dp_s, tp_s = s.split("x", 1)
            dp, tp = int(dp_s), int(tp_s)
        else:
            dp, tp = int(s), 1
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: expected 'DPxTP' (e.g. '4x2') or a "
            "device count (e.g. '8')") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"bad mesh spec {spec!r}: dp/tp must be >= 1")
    if dp * tp == 1:
        return None
    return dp, tp
