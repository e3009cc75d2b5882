import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess/multi-device tests (always run; marker "
        "allows -m 'not slow' for quick iterations)"
    )
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    """Engine/schedule/tune caches are process-global; without clearing them
    before every test, counter assertions ("plan built exactly once") depend
    on test order and cross-test cache pollution can mask regressions."""
    from repro.core.engine import clear_engine_cache, clear_schedule_cache
    from repro.core.gather_engine import clear_gather_engine_cache
    from repro.core.tune import clear_tune_cache

    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    clear_tune_cache()
    yield
