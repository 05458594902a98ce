"""Share of the traced window in which the card sat idle while the host
was in `multi_crop_batch` (the program's `sais.dino.crops` spans; rank 0
on several cards)."""

from portbench import program_spans


def read(t):
    return program_spans.idle_share_in(t, program_spans.session(t),
                                       "sais.dino.crops")
