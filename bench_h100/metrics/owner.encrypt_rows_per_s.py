"""owner.encrypt_rows_per_s: base rows over the seconds of the owner's
DataOwner.encrypt_vectors call in set-up (host clock; the call ends with
numpy ciphertexts on the host)."""


def read(ctx):
    return ctx.shape["n"] / ctx.setup["encrypt_s"]
