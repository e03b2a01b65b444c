"""engine.first_batch_s: the first search_batch of set-up (host clock):
the engine's upload of the ciphertexts and the filter's attach (for
int8 the codebook's training and encoding), then one batch."""


def read(ctx):
    return ctx.setup["first_batch_s"]
