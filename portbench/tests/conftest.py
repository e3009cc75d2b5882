import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    """The port's engine and schedule caches are process-wide: start each
    test without them."""
    from repro_torch.core.engine import clear_engine_cache, \
        clear_schedule_cache

    clear_engine_cache()
    clear_schedule_cache()
    yield
