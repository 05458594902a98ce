"""Share of the traced window in which the card sat idle while the host
was in the DINO step's update: clipping, AdamW, the parameter write, the
EMA and the center (the program's `sais.dino.update` spans; rank 0 on
several cards)."""

from portbench import program_spans


def read(t):
    return program_spans.idle_share_in(t, program_spans.session(t),
                                       "sais.dino.update")
