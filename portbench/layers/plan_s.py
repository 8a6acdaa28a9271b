"""plan_s: host seconds of the program's plan call in set-up (`prepare`,
or `prepare_product`), synchronised at both ends."""


def read(rec):
    return rec.span("plan")
