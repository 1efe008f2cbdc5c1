"""Scripts a user who embeds the port starts from: ``embed`` (the Player
API on a synthetic clip, written to y4m) and ``serving_farm`` (K
independent streams on one card).  Each runs as ``python -m
mpv_frame_interpolator_tpu_torch.examples.<name>``, on the card unless
``--device cpu`` asks for the plain versions."""
