// Launch entry points called with their arguments packed in one buffer.
//
// A ctypes call that converts each argument through `argtypes` costs about
// 2 us of host time more than one that passes a single pointer, which is as
// much as a small kernel's launch.  So every launching entry point
// `int treee_x(A...)` also gets `int treee_x_packed(const unsigned char* p)`,
// which reads the A... from `p` laid out as a C struct of those members would
// be (each at its natural alignment, in order: Python's struct module in its
// native "@" mode) and calls treee_x.  The typed entry point stays for callers
// that bind it directly.
#pragma once

#include <cstddef>
#include <cstring>
#include <tuple>

namespace treee {

template <typename T>
T unpack(const unsigned char* p, size_t& at) {
  at = (at + alignof(T) - 1) / alignof(T) * alignof(T);
  T v;
  std::memcpy(&v, p + at, sizeof(T));
  at += sizeof(T);
  return v;
}

template <typename R, typename... A>
R call_packed(R (*fn)(A...), const unsigned char* p) {
  size_t at = 0;
  // a braced list is evaluated left to right
  const std::tuple<A...> args{unpack<A>(p, at)...};
  return std::apply(fn, args);
}

}  // namespace treee

#define TREEE_PACKED(fn)                                          \
  extern "C" int fn##_packed(const unsigned char* p) {            \
    return treee::call_packed(fn, p);                             \
  }
