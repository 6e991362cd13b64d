from .runtime import (NativeCsvLogger, RateLoop, ShmTopic, Topic, get_lib,
                      plan_fit)

__all__ = ["Topic", "ShmTopic", "RateLoop", "NativeCsvLogger", "get_lib",
           "plan_fit"]
