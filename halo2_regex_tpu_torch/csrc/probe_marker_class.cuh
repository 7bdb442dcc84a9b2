// The class program of halo2_regex_tpu_torch/probes/probe_tpu57_lib.py
// (CLASS_PROG, Program.to_c), written by its class_header(); a test holds
// this file to it.  Do not edit by hand.
#pragma once

#include <cstdint>

struct MarkerClasses {
  uint32_t f, r, o, m, colon, at, cr, lf, name, dom;
};

// 76 ops over 84 registers
__device__ __forceinline__ void marker_classes(const uint32_t* p, MarkerClasses& c) {
  const uint32_t r0 = p[6];
  const uint32_t r1 = p[5];
  const uint32_t r2 = p[2];
  const uint32_t r3 = p[1];
  const uint32_t r4 = p[0];
  const uint32_t r8 = p[3];
  const uint32_t r11 = p[4];
  const uint32_t r16 = p[7];
  const uint32_t r5 = ~r4;
  const uint32_t r6 = r3 & r5;
  const uint32_t r7 = r2 & r6;
  const uint32_t r9 = ~r8;
  const uint32_t r10 = r7 & r9;
  const uint32_t r12 = ~r11;
  const uint32_t r13 = r10 & r12;
  const uint32_t r14 = r1 & r13;
  const uint32_t r15 = r0 & r14;
  const uint32_t r17 = ~r16;
  const uint32_t r18 = r15 & r17;
  const uint32_t r19 = ~r2;
  const uint32_t r20 = r6 & r19;
  const uint32_t r21 = r9 & r20;
  const uint32_t r22 = r11 & r21;
  const uint32_t r23 = r1 & r22;
  const uint32_t r24 = r0 & r23;
  const uint32_t r25 = r17 & r24;
  const uint32_t r26 = r3 & r4;
  const uint32_t r27 = r2 & r26;
  const uint32_t r28 = r8 & r27;
  const uint32_t r29 = r12 & r28;
  const uint32_t r30 = r1 & r29;
  const uint32_t r31 = r0 & r30;
  const uint32_t r32 = r17 & r31;
  const uint32_t r33 = ~r3;
  const uint32_t r34 = r4 & r33;
  const uint32_t r35 = r2 & r34;
  const uint32_t r36 = r8 & r35;
  const uint32_t r37 = r12 & r36;
  const uint32_t r38 = r1 & r37;
  const uint32_t r39 = r0 & r38;
  const uint32_t r40 = r17 & r39;
  const uint32_t r41 = r8 & r20;
  const uint32_t r42 = r11 & r41;
  const uint32_t r43 = r1 & r42;
  const uint32_t r44 = ~r0;
  const uint32_t r45 = r43 & r44;
  const uint32_t r46 = r17 & r45;
  const uint32_t r47 = r5 & r33;
  const uint32_t r48 = r19 & r47;
  const uint32_t r49 = r9 & r48;
  const uint32_t r50 = r12 & r49;
  const uint32_t r51 = ~r1;
  const uint32_t r52 = r50 & r51;
  const uint32_t r53 = r0 & r52;
  const uint32_t r54 = r17 & r53;
  const uint32_t r55 = r37 & r51;
  const uint32_t r56 = r44 & r55;
  const uint32_t r57 = r17 & r56;
  const uint32_t r58 = r12 & r41;
  const uint32_t r59 = r51 & r58;
  const uint32_t r60 = r44 & r59;
  const uint32_t r61 = r17 & r60;
  const uint32_t r62 = r5 | r33;
  const uint32_t r63 = r19 & r62;
  const uint32_t r64 = r9 | r63;
  const uint32_t r65 = r11 & r64;
  const uint32_t r66 = r3 | r4;
  const uint32_t r67 = r2 | r66;
  const uint32_t r68 = r8 | r67;
  const uint32_t r69 = r12 & r68;
  const uint32_t r70 = r65 | r69;
  const uint32_t r71 = r0 & r70;
  const uint32_t r72 = r19 & r33;
  const uint32_t r73 = r9 | r72;
  const uint32_t r74 = r11 & r73;
  const uint32_t r75 = r6 | r34;
  const uint32_t r76 = r2 & r75;
  const uint32_t r77 = r8 & r76;
  const uint32_t r78 = r12 & r77;
  const uint32_t r79 = r74 | r78;
  const uint32_t r80 = r1 & r79;
  const uint32_t r81 = r44 & r80;
  const uint32_t r82 = r71 | r81;
  const uint32_t r83 = r17 & r82;
  c.f = r18;
  c.r = r25;
  c.o = r32;
  c.m = r40;
  c.colon = r46;
  c.at = r54;
  c.cr = r57;
  c.lf = r61;
  c.name = r83;
  c.dom = r83;
}
