"""Model code of the port: what the serving path needs so far (the
dense decoder family's parameters, norms, rotary embedding and FFN).
The forward/training families are later slices (ROADMAP.md)."""
