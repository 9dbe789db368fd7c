def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and nvcc; skips without a card")
