def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (a hand-written kernel has no CPU mode); "
        "the test skips itself where none is found")
