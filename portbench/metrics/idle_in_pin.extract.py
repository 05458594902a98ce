"""Share of the traced window in which the card sat idle while the host
was copying frames into pinned memory (the program's `sais.extract.pin`
spans)."""

from portbench import program_spans


def read(t):
    return program_spans.idle_share_in(t, program_spans.session(t),
                                       "sais.extract.pin")
